from .core import (
    COMPUTE_DTYPE, DTYPES, Initializer, Module, act, cast, f32, init_params,
    load_store, mask, store, symexp, symlog, where)
from .layers import BlockLinear, Conv2D, DictConcat, Linear, MLP, Norm
from .heads import DictHead, Head, MLPHead
from .opt import Optimizer
from .train_utils import Normalize, SlowModel
from . import core
from . import dists
from . import layers
