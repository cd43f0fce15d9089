"""The distributed lookup engine (world-1 subset)."""
