"""Port of the sba_tpu sub-package of the same name."""
