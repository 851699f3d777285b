"""The per-frame step and the sequence loop."""
