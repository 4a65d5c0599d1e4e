"""Entry points of the port (the reference's ``launch/``, ``examples/``
and ``scripts/``): ``serve`` runs the ATA prefix-cache ModelServer,
``paper_repro`` the paper's figures over ``run_suite``, ``train`` the
training driver (``train_lm`` its end-to-end example and the
quickstart's training part), ``sensitivity``, ``bench``, ``sim_speed``,
``serving_scale``, ``serving_ata``, ``kernel_micro``, ``roofline``,
``telemetry_capture`` and ``check_regression`` the benchmark surface,
``bench_trend`` drift across a history of reports and ``calibrate`` the
paper suite against the paper's targets."""
