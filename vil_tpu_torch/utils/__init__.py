"""Utilities: the weight bridges from the JAX package's parameter trees and
from reference ``.pth`` files, checkpoints, metric logging, seeds and
profiling."""
