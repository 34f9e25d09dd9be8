"""Verification evaluation of the port: the 10-fold protocol on the host
and on the device, TPR@FAR, and the batch evaluation behind `eval`."""
