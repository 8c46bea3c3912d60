from .train import train
from .train_eval import train_eval
from .eval_only import eval_only
from .pretrain import pretrain

# The distributed actor-learner protocol imports lazily because it pulls in
# the remote RPC layer.
from . import lazy_parallel as parallel
