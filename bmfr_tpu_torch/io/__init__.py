"""Host-side inputs of the port (synthetic fixtures)."""
