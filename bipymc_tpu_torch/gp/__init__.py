from bipymc_tpu_torch.gp.kernels import matern32, matern52, squared_exp
from bipymc_tpu_torch.gp.regressor import GpFit, GpRegressor, default_params

__all__ = ["GpFit", "GpRegressor", "default_params", "matern32", "matern52",
           "squared_exp"]
