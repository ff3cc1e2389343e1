"""The mesh path of the port: one process per card over torch.distributed
(counterpart of prmers_tpu/parallel/)."""
