from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
from distributedvolunteercomputing_tpu_torch.training.steps import TrainState, make_train_step

__all__ = ["TrainState", "make_optimizer", "make_train_step"]
