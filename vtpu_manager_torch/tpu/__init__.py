"""Finding the cards on a node."""
