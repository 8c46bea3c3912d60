from .core import (
    COMPUTE_DTYPE, DTYPES, Initializer, Module, act, cast, f32, init_params,
    load_store, mask, store, symexp, symlog, torch_dtype, where)
from .layers import (
    GRU, Attention, BlockLinear, Conv2D, Conv3D, DictConcat, DictEmbed, Embed,
    Linear, MLP, Norm, Transformer, rope)
from .heads import DictHead, Head, MLPHead
from .opt import Optimizer, scope_params
from .train_utils import Normalize, SlowModel
from .stacked import StackedLayers
from . import core
from . import dists
from . import layers
from . import opt
