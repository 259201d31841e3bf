"""Launch: the train and serve command lines (``python -m
repro_torch.launch.train`` / ``.serve``) and the optimizer spec.  The
mesh, dry-run and HLO-analysis tools arrive with the mesh slice."""
