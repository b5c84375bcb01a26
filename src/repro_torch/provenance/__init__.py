from repro_torch.provenance.store import (  # noqa: F401
    LinkType,
    NodeType,
    ProvenanceStore,
    QueryBuilder,
    configure_store,
    current_store,
)
