"""The benchmark's own yardstick: traffic, weights, costs, peaks and trace
arithmetic. Later changes to the program cannot move it; it imports nothing
of the program, of JAX or of the JAX package."""
