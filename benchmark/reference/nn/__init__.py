from .core import (
    COMPUTE_DTYPE, Initializer, Module, act, cast, f32, mask, store,
    symexp, symlog, torch_dtype, where)
from .layers import BlockLinear, Conv2D, DictConcat, Linear, MLP, Norm
from .heads import DictHead, Head, MLPHead
from .opt import Optimizer, scope_params
from .train_utils import Normalize, SlowModel
from . import core
from . import dists
from . import layers
from . import opt
