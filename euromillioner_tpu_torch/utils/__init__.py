"""Host-side utilities: error taxonomy, logging, EMT1 serialization, the
native host library's loader."""
