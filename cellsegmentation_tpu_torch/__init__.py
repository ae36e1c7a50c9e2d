"""cellsegmentation_tpu_torch — the PyTorch/CUDA port of cellsegmentation_tpu.

The JAX package ``cellsegmentation_tpu`` stays the reference; this package
mirrors its layout (cli/, core/, data/, models/, ops/, kernels/, csrc/,
train/, infer/, utils/) so each module's counterpart is found under the
same path. Its kernels are hand-written for Hopper (``csrc/``, built with
nvcc at first use, see ``kernels/build.py``).

What is ported so far, on the ResNet family: stage 1 (image-count training,
``train.trainers.train_stage1``, and ``infer.inference_image``, with the
``train_image`` and ``test_count`` CLIs) and stage 2 (the dense shared-stem
q8dg tile sweep, ``train.steps.make_tile_infer_step``, and the MIL cycle,
``train.trainers.train_stage2``). Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.

Layouts at public functions follow the JAX package: NHWC images and
features, and the whole-tile ``[M, px*C]`` int8 layout (column
``(h*w_in + w)*C + c``) in the GEMM trunk.
"""

__version__ = "0.1.0"
