"""One-card LM training (port of ``repro.train``): the chunked loss, the
microbatched AdamW step and the filtered gradient sync's pieces."""
