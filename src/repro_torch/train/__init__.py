"""Step functions (the serve steps of the slice)."""
