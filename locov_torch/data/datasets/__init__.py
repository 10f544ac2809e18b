"""Dataset registration: COCO and LVIS (counterpart of
``locov_tpu/data/datasets``)."""
