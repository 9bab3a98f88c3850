"""sdpcutsel: a JAX cutting-plane framework for nonconvex BoxQP/QCQP.

Re-implements the capabilities of the reference repo ``rb2309/SDPCutSel-via-NN``
(see SURVEY.md; the read-only reference mount was empty at survey time, so the
blueprint is the published paper: Baltean-Lugojan, Bonami, Misener, Tramontani,
"Scoring positive semidefinite cutting planes for quadratic optimization via
trained neural networks") as a new accelerator design in JAX, run on NVIDIA
GPUs:

- ``instances``  — BoxQP/QCQP instance generation, parsing, registry.
- ``relax``      — McCormick relaxation as structured dense operators + cut pool.
- ``lp``         — restarted-PDHG LP solver (+ scipy-HiGHS CPU oracle).
- ``cuts``       — candidate enumeration, batched Z(rho) assembly, batched small
                   eigh, cut generation.
- ``models``     — MLP cut scorers (plain jnp), exact-label generation,
                   training.
- ``ops``        — batched Jacobi eigensolver, top-k selection.
- ``parallel``   — mesh construction, candidate/instance sharding, global top-k.
- ``loop``       — the cutting-plane round controller and SDP-bound computation.
- ``baseline``   — pure numpy + HiGHS CPU replica of the reference algorithm.
- ``utils``      — config, structured logging, checkpointing, profiling.
"""

__version__ = "0.1.0"
