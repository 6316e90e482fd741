"""Faults planted under a run of the harness by the tests (each a hook the
mesh runner's ranks call by name, or a patch the tests apply)."""


def no_exchange():
    """The slab's all-gather between ranks left out: each rank keeps its
    own rows."""
    from headpose_tpu_torch.runtime import detector

    detector.all_gather_rows = lambda local, group=None: local
