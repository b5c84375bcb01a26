from repro_torch.provenance.store import (  # noqa: F401
    LinkType,
    NodeType,
    ProvenanceStore,
    QueryBuilder,
    configure_store,
    current_store,
)
from repro_torch.provenance.archive import (  # noqa: F401
    ARCHIVE_VERSION,
    ArchiveError,
    ImportResult,
    compute_closure,
    export_archive,
    import_archive,
    read_manifest,
)
