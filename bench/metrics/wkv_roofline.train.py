"""wkv_roofline.train: the WKV forward and backward calls' bounds at the
job's shape (bytes of r, k, v, the f32 decay and output, and the backward's
reads and writes, once; 6 and 8 D^2 FLOPs a token and head) over their
device time, in %."""
from bench.portbench import costs
from bench.portbench.readers import WKV_BWD, WKV_FWD, train_kernel_roofline


def read(run):
    c, mix = run.cfg, run.cell.traffic
    shape = (int(mix["batch"]), int(mix["seq_len"]), c.rnn_heads, c.d_head)
    return train_kernel_roofline(run, WKV_FWD, WKV_BWD, costs.wkv_forward(*shape),
                                 costs.wkv_backward(*shape))
