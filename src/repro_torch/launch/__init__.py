"""Entry points of the LM substrate (the port of the reference's
``launch/``): ``serve`` runs the ATA prefix-cache ModelServer."""
