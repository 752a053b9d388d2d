"""Sweep driver CLIs, one per reference Eval_run script (port of
``vae_equalizer_tpu/drivers``). Run as modules, e.g.::

    python -m vae_equalizer_tpu_torch.drivers.eval_run_dp --pallas-frame --batch-lr-axis
    python -m vae_equalizer_tpu_torch.drivers.eval_run_shaping_vaele --pallas-frame
    python -m vae_equalizer_tpu_torch.drivers.eval_run_vaenn --pallas-frame
    python -m vae_equalizer_tpu_torch.drivers.eval_run_shaping_cma
    python -m vae_equalizer_tpu_torch.drivers.eval_run_dfe
    python -m vae_equalizer_tpu_torch.drivers.eval_run_dp --quick --device cpu

Defaults reproduce the reference workloads on the card; results go to
results/ as incremental JSONL plus a reference-layout .mat.
"""
