"""Static-shape neighbourhood search."""
