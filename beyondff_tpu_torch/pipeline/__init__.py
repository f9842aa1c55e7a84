"""Stage drivers."""
