"""Small helpers: the JET colormap and the entry points' device check."""
