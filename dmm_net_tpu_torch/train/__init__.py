"""Training: losses, the optimizer, the clip-BPTT train step and loop."""
