"""The measurement probes, on the card: counterparts of ``tools/int8_matmul_probe.py``
and ``tools/mfu_levers.py`` (the probes that launch kernels).

    python -m flyp_tpu_torch.tools.int8_matmul_probe [pallas] [batch] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.mfu_levers [matmul|depth|row_quant|adamw|adamw_pallas|zeroshot|all] [--device cuda|cpu]

Each probe's kernel (T1: the probe GEMM in bf16 and int8; T2: the per-head
score sum; T3: the row-count GEMM; T4: the fused AdamW update) is a CUDA
source in ``flyp_tpu_torch/csrc``, with its plain PyTorch version beside the
op.  ``--device cpu`` runs the plain versions, a functional check only.
"""
