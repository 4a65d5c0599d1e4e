"""Entry points of the port (the reference's ``launch/`` and
``examples/paper_repro.py``): ``serve`` runs the ATA prefix-cache
ModelServer, ``paper_repro`` the paper's figures over ``run_suite``."""
