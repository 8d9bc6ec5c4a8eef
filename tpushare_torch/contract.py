"""The grant env the device plugin injects into a workload container.

The port's own copy of the names in ``tpushare/contract/constants.py``
that its workloads read; the scheduler side is unchanged and keeps
injecting these TPU-era names.
"""

ENV_VISIBLE_CHIPS = "TPU_VISIBLE_CHIPS"         # e.g. "0,1,4,5"
ENV_HBM_LIMIT = "TPUSHARE_HBM_LIMIT_MIB"        # per-chip grant, MiB
ENV_HBM_CHIP_TOTAL = "TPUSHARE_HBM_CHIP_TOTAL_MIB"
# the granted box's dims ("2x2"), present for contiguous grants
ENV_PLACEMENT_BOX = "TPUSHARE_PLACEMENT_BOX"
