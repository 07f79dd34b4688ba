"""The plain reference the benchmark's check holds the program to.

Plain PyTorch and numpy, fp32 unless a control lowers it, one row at its
own length, no kernels, caches or batching; it imports nothing of the
program (``benchmark/tests/test_bench_imports.py``). ``t3.py`` and
``pipeline.py`` are written for the check: T3 as one teacher-forced causal
forward where the program decodes through its KV cache, and the pipelines
row by row. The modules below them (``layers``, ``dsp``, ``fbank``,
``resample``, ``s3tokenizer``, ``xvector``, ``voice_encoder``,
``conformer``, ``unet``, ``flow``, ``hifigan``) are frozen copies of the
port's plain paths, as they stood when the port's CPU tests held them to
the JAX package, cut to what the check runs: the conformer's and the
UNet's attention dense, the vocoder without masks or streaming state.
"""
