"""Developer tools run on the card (not used by the renderer)."""
