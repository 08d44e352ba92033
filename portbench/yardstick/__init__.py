"""The benchmark's frozen arithmetic: the card's peaks, the least time each
kernel could take at its shapes, and the model FLOPs that ``mfu`` counts.

Nothing here imports the program: later changes to the program cannot move
the yardstick.
"""
