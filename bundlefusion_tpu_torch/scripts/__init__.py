"""Long-run, capacity and measurement scripts of the port: the counterparts
of the JAX package's ``scripts/``.

Each module is ``main(argv=None) -> dict`` and runs as ``python -m
bundlefusion_tpu_torch.scripts.<name> [--device cpu] [--out DIR] ...``: on
the CUDA card unless ``--device cpu`` is given, writing its JSON only under
``--out`` (default ``chiprun_out/scripts/`` of the checkout). On the CPU the
modules that run the engine take the small test configuration (160x120
input, 80x60 integration), as the JAX scripts do off the TPU. Synthetic
sequences are rendered in-process on the module's device and cached by
``seq_cache``.

| module | JAX counterpart |
|---|---|
| ``seq_cache`` | ``scripts/render_seq.py``, ``bench.py`` ``seq_cached`` |
| ``drift_demo`` | ``scripts/drift_demo.py`` |
| ``profile_boundary`` | ``scripts/profile_boundary.py`` |
| ``drift_capacity`` | ``scripts/drift_capacity.py`` |
| ``scale_run`` | ``scripts/scale_run.py`` |
| ``ablate`` | ``scripts/ablate.py`` |
| ``fidelity_report`` | ``scripts/fidelity_report.py`` |
| ``make_fixture`` | ``scripts/make_fixture.py`` |
| ``verify_drive`` | ``scripts/verify_drive.py`` |
| ``scaling_harness`` | ``scripts/scaling_harness.py`` |
"""
