"""flash_roofline.train: the flash-attention forward and backward calls'
bounds at the job's shape (causal: 4 H D FLOPs a visible pair forward, 10
backward; bytes of each input and output once) over their device time, in
%."""
from bench.portbench import costs
from bench.portbench.readers import FLASH_BWD, FLASH_FWD, train_kernel_roofline


def read(run):
    c, mix = run.cfg, run.cell.traffic
    shape = (int(mix["batch"]), int(mix["seq_len"]), c.n_heads, c.n_kv_heads, c.d_head)
    return train_kernel_roofline(run, FLASH_FWD, FLASH_BWD, costs.flash_forward(*shape),
                                 costs.flash_backward(*shape))
