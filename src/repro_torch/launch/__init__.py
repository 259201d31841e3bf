"""Launch: the train and serve command lines (``python -m
repro_torch.launch.train`` / ``.serve``), the optimizer spec and mesh
construction (``launch.mesh``).  The dry-run and HLO-analysis tools
arrive with the model-mesh slice."""
