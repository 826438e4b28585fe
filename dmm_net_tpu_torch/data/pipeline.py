"""Input normalisation constants (the rest of the JAX package's input
pipeline is not ported yet)."""

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
