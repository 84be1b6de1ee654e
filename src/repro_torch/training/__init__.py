"""Step functions of the port (the serving-side roots so far)."""
