"""Model builders (the lstm family), the registry and weight conversion."""
