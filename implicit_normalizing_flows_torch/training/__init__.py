from .checkpoints import load_npz_tree
from .convert import jax_variables_to_torch, load_jax_checkpoint
from .ema import ema_apply, ema_init
from .loops import (DensityTrainStep, ImageTrainStep, dequantize,
                    make_density_eval_step, make_density_train_step, make_image_eval_step,
                    make_image_train_step, standard_normal_logprob)
from .lr_schedule import linear_warmup
from .optimizers import adam, global_norm

__all__ = ["load_npz_tree", "jax_variables_to_torch", "load_jax_checkpoint",
           "dequantize", "make_image_eval_step", "make_image_train_step",
           "ImageTrainStep", "standard_normal_logprob", "DensityTrainStep",
           "make_density_train_step", "make_density_eval_step", "adam", "global_norm",
           "linear_warmup", "ema_init", "ema_apply"]
