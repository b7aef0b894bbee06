"""The port's parallel layer over ``torch.distributed`` (ROADMAP A9): the
mesh (``mesh.py``), its collectives (``comm.py``), the input grid
(``multihost.py``), head-group tensor parallelism (``tp.py``) and FSDP
(``fsdp.py``), the counterparts of ``flyp_tpu/parallel/``."""
