"""Launch: the train and serve command lines (``python -m
repro_torch.launch.train`` / ``.serve``), the cells' inputs and specs
(``launch.specs``), mesh construction and the models' ambient mesh
(``launch.mesh``).  The dry-run and HLO-analysis tools are still to
port."""
