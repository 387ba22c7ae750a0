"""Tools of the port that run its entry points end to end."""
