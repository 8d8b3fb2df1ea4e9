"""Device selection, precision profiles and the in-flight window."""
