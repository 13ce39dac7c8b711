from repro_torch.data.synthetic import (make_fmnist_like, partition_dirichlet,
                                        partition_iid,
                                        partition_noniid_classes)

__all__ = ["make_fmnist_like", "partition_dirichlet", "partition_iid",
           "partition_noniid_classes"]
