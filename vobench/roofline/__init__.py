"""One file per hand-written kernel of the program (`csrc/*.cu`): its
bytes and operations per launch from the shapes of the call, and the
names under which the profiler's trace shows it.

Each module has `ID` (the kernel table's B1-B5), `KERNELS` (trace names
of the CUDA functions one launch runs, each once; the first counts the
launches) and `calls(vo, cam, lanes)`: [(bytes, operations)] of every
launch that one VO step of `lanes` lanes makes under the configuration
`vo` (the `vo` table of a `configs/*.json`) and camera `cam` (its `camera`
table), in launch order; [] where the step does not launch it.  A mode
whose call shapes are not modelled here raises NotImplementedError.
The shapes are worked out here, not read from the program, so that no
change of the program moves the bound.
"""
