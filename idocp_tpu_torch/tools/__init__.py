"""The measurement tools of the JAX package's ``tools/``, on the port.

Each module is the twin of the file of the same name there and runs as
``python -m idocp_tpu_torch.tools.<name>`` (``--help`` lists its arguments):

``runtime_profile``     per-phase host and device ms of the batched trot
                        update, kernel launches, the device's idle share
``trace_capture``       a ``torch.profiler`` trace of main-path updates and
                        its top device operations
``mfu_report``          FLOPs, bytes and the roofline of one update
``accuracy_oracle``     f32 against converged f64 on the BASELINE cases
``linearize_profile``   the sub-phases of one stage linearization
``compile_profile``     first-call seconds, aten ops and kernel launches per
                        solver component (eager PyTorch compiles nothing)
``chol_kernel_bench``   the hand kernel against the library chain and its
                        plain version
``scaling_evidence``    ``scaling_report`` over processes (gloo or NCCL)

Every ``main`` runs on the card unless told ``--device cpu`` and raises when
there is no card; a number that needs the card is ``None`` on the CPU. The
JSON files go into ``tools_out/`` unless a path is given. ``_workloads``
holds the builders the tools and ``chip_smoke.py`` share.
"""
