"""A frozen copy of the analysis pipeline of ``stratum_dsp_tpu_torch`` as it
stood at commit 83ec59a537072642745bea8c0fcfe37a5a357b67, in plain PyTorch.

The benchmark's comparison holds the port to this copy. Its modules are the
port's files of that commit (``config.py``, ``errors.py``, ``result.py``,
``analysis/{pipeline,confidence,decode,metadata}.py``, ``features/``,
``ops/{masked,stft,framesum,novelty,polyphase,downbeats,viterbi}.py``,
``preprocessing/``), imported by relative names, with three changes:

* each of the four CUDA kernels' wrappers (``ops/novelty.py``,
  ``ops/polyphase.py``, ``ops/downbeats.py``, ``ops/viterbi.py``) calls its
  plain PyTorch version on every device, and the launch, the kernel's limits
  and its ``bound_ms`` are gone (``portbench/roofline.py`` keeps that
  arithmetic);
* ``analysis/pipeline.py`` has no mesh entry: the reference runs on one
  device, and the branches that would import ``parallel/`` are never taken;
* this package and ``analysis/__init__.py`` export nothing.

Nothing here imports ``stratum_dsp_tpu_torch``, ``stratum_dsp_tpu`` or JAX.
"""
