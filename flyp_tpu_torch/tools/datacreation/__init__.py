"""Offline dataset-preparation tools (the upstream `datacreation_scripts/`).

Counterpart of ``flyp_tpu/tools/datacreation/``; the CSVs are byte-equal to
the JAX tools' on the same trees.  Each module is a CLI
(`python -m flyp_tpu_torch.tools.datacreation.<name>`) that
emits the tab-separated contrastive CSVs the training pipeline consumes
(``title\tfilepath[\tlabel\tguidance\timg_id]``) or reorganizes raw
releases into the ImageFolder trees the dataset registry expects.  Unlike
the upstream scripts, paths are arguments, not hardcoded author
directories.
"""
