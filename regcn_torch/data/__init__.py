from regcn_torch.data.dataset import TKGData, load_data  # noqa: F401
from regcn_torch.data.snapshots import (  # noqa: F401
    Snapshot,
    split_by_time,
    build_snapshot,
    build_history,
    stack_history,
    pad_triples,
    dilate_snapshots,
)
from regcn_torch.data.answers import (  # noqa: F401
    AnswerFilter,
    build_answer_filter,
    build_answer_filters_by_time,
)
