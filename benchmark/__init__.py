"""The benchmark of idocp_tpu_torch: ``python -m benchmark.run --workload
<config>.<traffic> --seed <n> --seconds <s> --trace <0|1>``."""
