"""Datasets, samplers, loaders (host batches and index matrices), host
augmentation, and the device-resident data path; the prefetch engine is
``data/prefetch.py``."""
from .cifar10 import Dataset, load, synthetic
from .loader import EvalLoader, TrainLoader
from .resident import ResidentData

__all__ = ["Dataset", "EvalLoader", "ResidentData", "TrainLoader", "load",
           "synthetic"]
