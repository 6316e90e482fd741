"""How a cell's traffic is driven: `stream` (one process, one card,
`runtime.streaming.detect_stream`) and `mesh` (one NCCL rank a card).  A
traffic file names its runner."""
