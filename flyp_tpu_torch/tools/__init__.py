"""The repo's measurement and check tools, on the card: counterparts of the
scripts in ``tools/``.

    python -m flyp_tpu_torch.tools.int8_matmul_probe [pallas] [batch] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.mfu_levers [matmul|depth|row_quant|adamw|adamw_pallas|zeroshot|all] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.grad_cache_bench [--model ViT-L/14] [--batch 512] [--chunks 8] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.serving_bench [model] [batch,batch,...] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.kernel_breakdown [batch] [model] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.rn50_breakdown [batch] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.convergence_check [steps] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.bf16_drift [steps] [batch] [pool] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.e2e_check [--epochs 2] [--batch-size 64] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.loop_sync_ab [batch] [model] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.eval_sync_ab [model] [batch] [--device cuda|cpu]
    python -m flyp_tpu_torch.tools.host_decode_bench [n_images] [px]

The probes' kernels (T1: the probe GEMM in bf16 and int8; T2: the per-head
score sum; T3: the row-count GEMM; T4: the fused AdamW update) are CUDA
sources in ``flyp_tpu_torch/csrc``, with their plain PyTorch versions
beside the ops.  The other tools drive the main path (B1-B3 on the default
route) and take their FLOP counts and MFU from ``utils/profiling.py``.
``--device cpu`` runs the plain versions, a functional check only;
``host_decode_bench`` measures the host alone.  ``validate_checkpoint``,
``validate_data`` and ``datacreation`` are the offline data tools.
"""
