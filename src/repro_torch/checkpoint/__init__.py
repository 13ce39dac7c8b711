from repro_torch.checkpoint.io import (load_blob, load_pytree,
                                       load_sim_params, save_blob,
                                       save_pytree)

__all__ = ["load_blob", "load_pytree", "load_sim_params", "save_blob",
           "save_pytree"]
