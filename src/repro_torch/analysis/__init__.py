"""Roofline terms and the report, the counterpart of `repro.analysis`.

  `roofline`  three-term roofline (compute, HBM, NVLink) of dry-run
              records at one H100's peaks; the port's one definition of
              those peaks
  `report`    the dry-run and roofline tables, and the per-op utilization
              report of a telemetry snapshot (``--metrics``)

    PYTHONPATH=src python -m repro_torch.analysis.report --metrics snap.json
    PYTHONPATH=src python -m repro_torch.analysis.report --dir results/dryrun
"""
