"""Detection evaluation: COCO and LVIS protocols and the loop that
feeds them (counterpart of ``locov_tpu/evaluation``)."""
