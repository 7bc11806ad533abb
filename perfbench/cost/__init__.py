"""The frozen yardstick: bytes and operations the work needs, from shapes
alone, and the card's published peaks. A later change to the program's
kernels changes none of it."""
