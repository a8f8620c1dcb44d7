"""The plain reference: the effects, the style net, its training step and
the streaming chain in plain PyTorch and NumPy, written from the published
designs. It imports nothing of the program and takes nothing the program
made."""
