"""Datasets, samplers, index matrices and the device-resident data path."""
from .cifar10 import Dataset, load, synthetic
from .loader import EvalLoader, TrainLoader
from .resident import ResidentData

__all__ = ["Dataset", "EvalLoader", "ResidentData", "TrainLoader", "load",
           "synthetic"]
