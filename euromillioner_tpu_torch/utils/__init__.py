"""Host-side utilities: error taxonomy, logging, EMT1 serialization."""
