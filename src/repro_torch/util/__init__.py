"""Small helpers shared by the port's training path."""
