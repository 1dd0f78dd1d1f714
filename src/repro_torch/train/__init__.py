"""Training (the port's ``repro/train``): AdamW with the cosine schedule
and global-norm clipping (``optimizer``), gradient compression at the
accumulation boundary with error feedback (``compression``) and the train
step with microbatch accumulation (``train_step``)."""
