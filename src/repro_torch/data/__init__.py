from repro_torch.data.synthetic import (make_fmnist_like, make_token_batch,
                                        partition_dirichlet, partition_iid,
                                        partition_noniid_classes)

__all__ = ["make_fmnist_like", "make_token_batch", "partition_dirichlet",
           "partition_iid", "partition_noniid_classes"]
