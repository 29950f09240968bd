"""Step functions of the port."""
