"""The plain reference: float32 PyTorch from the published equations,
independent of the program under test."""
