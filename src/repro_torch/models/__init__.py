"""Model stack of the port: layers, attention, the uniform transformer."""
