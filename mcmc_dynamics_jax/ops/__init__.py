from .lnlike_kernels import model_lnlike_batched
from .background_kernel import background_logsumexp
from .sufficient import ConstantSufficientStats
from .model_sufficient import ModelSufficientStats
from .model_tensor import ModelTensorStats

__all__ = ["model_lnlike_batched",
           "background_logsumexp",
           "ConstantSufficientStats", "ModelSufficientStats",
           "ModelTensorStats"]
