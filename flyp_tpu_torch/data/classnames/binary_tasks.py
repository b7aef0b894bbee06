"""SST-2 and PatchCamelyon class names (public data, src/datasets/sst2.py:91, patchcamelyon.py:93)."""

sst2_classnames = ["negative", "positive"]

patchcamelyon_classnames = ["lymph node", "lymph node containing metastatic tumor tissue"]

