"""Training: the semi-supervised CycleGAN step (``cyclegan``), its losses,
LR schedule and replay pools, and the segmentation metrics."""
