from .core import (
    COMPUTE_DTYPE, DTYPES, Initializer, Module, act, cast, f32, init_params,
    load_store, mask, store, symexp, symlog, torch_dtype, where)
from .layers import (
    GRU, BlockLinear, Conv2D, DictConcat, DictEmbed, Embed, Linear, MLP,
    Norm)
from .heads import DictHead, Head, MLPHead
from .opt import Optimizer, scope_params
from .train_utils import Normalize, SlowModel
from . import core
from . import dists
from . import layers
