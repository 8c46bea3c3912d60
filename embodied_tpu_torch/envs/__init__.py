"""Environment adapters. Only the dependency-free Dummy env so far."""

from .dummy import Dummy
