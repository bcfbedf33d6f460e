"""The port of `paddle_tpu/streaming/`: so far only the error type that
the model registry's deploy gate raises (`export_int8.ExportToleranceError`).
The int8 export itself, and the rest of the streaming package, are ROADMAP
Queue 1 item 10."""
