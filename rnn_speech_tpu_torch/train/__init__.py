"""Training-side modules of the port (restore only in this slice)."""
