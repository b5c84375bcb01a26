"""A process of ``tests/test_torch_store.py``'s migration race: it waits
at a barrier with the others, then opens one profile (kept apart from the
test module so that a spawned process imports the store and nothing
else)."""

from __future__ import annotations


def open_profile(path: str, barrier, errors) -> None:
    """Open the profile at ``path`` once every process is at ``barrier``;
    put what the open raised on ``errors``."""
    from repro_torch.provenance.store import ProvenanceStore

    barrier.wait()
    try:
        ProvenanceStore(path).close()
    except Exception as exc:  # noqa: BLE001 - reported to the test
        errors.put(repr(exc))
