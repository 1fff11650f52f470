"""One plain reference model per configuration, found by its name."""
