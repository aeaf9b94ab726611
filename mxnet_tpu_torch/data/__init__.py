"""The asynchronous host data pipeline (counterpart of
``mxnet_tpu/data/``): worker threads and read-ahead over any
``DataIter`` or RecordIO shards, staging into the step's device, a
checkpointable cursor (``fit(auto_resume=True)`` restores the data
position) and ``data_report()``, the "are we input-bound?" view of the
telemetry registry."""
from .pipeline import (DataPipeline, RecordIOSource, from_recordio,
                       maybe_wrap_for_fit)
from .report import data_report
from . import workers

__all__ = ["DataPipeline", "RecordIOSource", "from_recordio",
           "maybe_wrap_for_fit", "data_report", "workers"]
