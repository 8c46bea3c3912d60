"""Run protocols: the single-host scripts `train`, `train_eval`,
`eval_only` and `pretrain`. The distributed `parallel` scripts come with
the distribution slice."""

from .train import train
from .train_eval import train_eval
from .eval_only import eval_only
from .pretrain import pretrain
