from .checkpoints import load_npz_tree
from .convert import jax_variables_to_torch, load_jax_checkpoint
from .loops import dequantize, make_image_eval_step, standard_normal_logprob

__all__ = ["load_npz_tree", "jax_variables_to_torch", "load_jax_checkpoint",
           "dequantize", "make_image_eval_step", "standard_normal_logprob"]
