from vitax_torch.train.optim import (  # noqa: F401
    adamw,
    param_leaves,
    sgd_momentum,
    step_scheduler,
)
from vitax_torch.train.schedules import (  # noqa: F401
    cosine_annealing_lr,
    cosine_with_warmup_lr,
    onecycle_lr,
    onecycle_momentum,
    token_keep_switch_epoch,
)
from vitax_torch.train.steps import (  # noqa: F401
    TrainState,
    create_train_state,
    cross_entropy,
    make_eval_step,
    make_train_step,
    topk_accuracy,
)
