"""Runnable checks of the port: ``gmm_posterior`` trains a member on a 1-D
Gaussian mixture and holds its posterior against the analytic one."""
