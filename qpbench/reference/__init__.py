"""The plain side of the check: the constraint sets, the Eq. 25 residual and
a projected-gradient solver in plain PyTorch, written from the sets'
definitions alone.  Nothing here imports the program under test; it works
out again from A and b whatever it needs, and reads the program's answers
only to judge them."""
