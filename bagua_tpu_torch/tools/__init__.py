"""The operator tools, run as ``python -m bagua_tpu_torch.tools.<name>``:
``diagnose_hang`` (join flight dumps into a hang report),
``perf_doctor`` (one ``perf_regression`` incident as a report),
``export_timeline`` (spans and fleet timelines as a Chrome trace) and
``fault_injection`` (the resilience lane: real signals against a gang
under the launcher, each resumed run held bitwise to the uninterrupted
one).  Each keeps the command line and the output of the JAX package's
tool of the same name in ``ci/``."""
