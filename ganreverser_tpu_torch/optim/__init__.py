from .optimizers import (Optimizer, adadelta, adagrad, adam, adamax,
                         make_optimizer, rmsprop, sgd)
from .transforms import clamp_grads, l1_penalty, l2_penalty, regularize
