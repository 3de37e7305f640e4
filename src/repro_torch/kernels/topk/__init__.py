"""Row-wise k-smallest selection kernel (`csrc/topk.cu`) and its plain
version."""
