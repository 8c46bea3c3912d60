from .core import (
    COMPUTE_DTYPE, DTYPES, Initializer, Module, act, cast, f32, init_params,
    load_store, mask, store, symlog)
from .layers import BlockLinear, Conv2D, DictConcat, Linear, MLP, Norm
from .heads import DictHead, Head, MLPHead
from . import core
from . import dists
from . import layers
