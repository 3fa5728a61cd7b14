"""The plain reference: PyTorch and NumPy written from the equations the
configurations state, float32 with TF32 off unless a lower precision is
asked for (the control). Nothing here imports the program under test."""
