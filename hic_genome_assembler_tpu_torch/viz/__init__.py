"""Contact-map visualization."""
