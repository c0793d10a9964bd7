#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths (the full-graph
baselines, the FIT-GNN curriculum, its distributed forms at one rank, the
flat data mesh's steps, the graph-level tasks and a raw Planetoid set) on
one GPU and hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure exits non-zero before the result lines):

1. the card's name and power limit; build every native library (one
   ``nvcc`` per CUDA source and the Leiden g++ build, all in parallel) and
   print each kernel's registers and spilled bytes from ``ptxas -v``;
2. the bench graph (seed 0, 169,344 nodes, 128 features, 40 classes, the
   generator of ``bench.py``), saved as an npz dataset in a temp root;
3. kernels, each against its plain version (rtol 1e-4, atol
   1e-4·max|ref|: f32 sums in another order), with kernel, plain and
   library times and the bound from bytes and operations: on the GCN
   operator K1 (``bsr_spmm_acc``) and K3 (``segmm_spmm``) at F=128 and
   512, and the hybrid SpMM on a small graph against a dense float64
   product; on the GAT (``att_unit``) operator, whose tile split must equal
   the GCN operator's, K4 (``dyn_tiles``) and K4ᵀ (``dyn_tiles_t``) at
   F=128 and 512, K5 (``dyn_grad_blocks``, bound at the tensor cores' TF32
   rate for its three passes; beside ``torch.bmm`` on slabs gathered
   first, TF32 off) at F=128 and 512 and K3w
   (``segmm_weighted_raw``) at F=40 (off the path) and 64, and on the
   transpose CSR at F=512 (K6's ``dx``, the permutation passed to the
   kernel); then the fused tile attention and K6 at F=128 and
   512: K7rm (``att_rowmax``), K7f (``att_fwd``), K7bt (``att_bwd_t``'s
   ``dx`` walk; the path launches it at F=512 only), K7s (the score pass of
   ``att_bwd_scores``: ``dsdst`` and ``dssrc``'s column partials, timed
   alone and with both outputs, beside ``torch.sparse.sampled_addmm`` for
   its ⟨g, x⟩ alone; two launches bit-equal; the longest block row's tile
   count printed), K7sums (``att_sums``, ``dssrc`` and ``dsdst`` from the
   partials) and K6
   (``segmm_weighted_den_raw``), each beside the two-stage path it
   replaces (materialised tile scores, K4/K4ᵀ/K5 and PyTorch's
   elementwise work, forward and autograd backward), whose outputs and
   gradients they must also match; then on the opt-in operators of the
   GCN graph (``use_diag`` and ``tile_group=2`` through
   ``build_optimized_graph``, ``use_rowwalk`` through ``build_hybrid``) K2
   (``bsr_spmm_fwd``), K9 (``bsr_spmm_grouped``) and K10
   (``bsr_spmm_rowwalk``) at F=128 and 512, K8 (``diag_spmm``) forward and
   transpose with and without ``init`` at F=128 and 512 (after the
   diagonal blocks' non-zero count and fill), and K11
   (``philox_dropout``) at (N_pad, 512), bit for bit.  The straggler
   sum's forms (K3, K3w, K6) are launched twice (bit-equal) and timed by
   their device time (``device_ms``: the kernel alone, which is all their
   wrappers launch) and with their wrappers' host work (``wrapper_ms``),
   each beside the launch shape it took (lanes a row, floats a lane,
   gathers in flight, rows a CTA);
4. gradients: one GAT and one GCN training step (hidden 512, dropout off,
   the same seed-0 init) with the kernels and then with the plain versions
   patched in; the loss and every parameter gradient within the tolerance
   above, and the launches of the kernel step: GAT K4 ×2, K4ᵀ ×1 (layer
   0's input, the raw features, needs no gradient), K5 ×2; GCN K1 ×3 and
   K3 ×3 (two forward, one backward for layer 1: layer 0 aggregates the
   raw features); then the GAT step under ``FITGNN_GAT_FUSED_TILES=1
   FITGNN_GAT_SEGMM_DEN=1``, with kernels, with plain versions, and held
   against the default step too: K7f ×2, K7s ×2 and K7sums ×2 (both score
   gradients in each layer), K7bt ×1 (``dx`` only in layer 1), K6 ×2, K3w
   ×1 (K6's ``dx`` in layer 1);
5. the opt-ins through the library surface, every counter at 0 just
   before each counted run: GCNConv at hidden 512 with
   ``fused_dropout=True, bit_dropout=False`` (dropout 0.5: K11 ×4 a
   step) on each opt-in operator, one step's loss, gradients and eval
   forward against the default operator's under the same seed (the same
   K11 masks), then 2 epochs (``gc_train_step`` + ``gc_eval_step``) with
   the walk ×3 a step and ×2 an eval (K8 and K1 / K9 / K10) and K3 alike;
   eval forwards on a forward-only operator (the BCSR without its
   transpose: K3 and K2 ×2 each) against the default forward, and
   ``spmm(operator=BsrMatrix)`` forward and backward (K2 ×2);
6. train: ``train --baseline`` through the port's CLI on ``cuda``, every
   launch counter at 0 just before each run: GATConv at hidden 512 for 3
   epochs, GCNConv at hidden 512 for 2 epochs, GATConv at hidden 64 for 1
   epoch (its aggregations are 64 wide, so K3w runs; the widths K3w
   launches at are tallied and must be 64 alone), GATConv at hidden
   512 for 2 epochs with ``FUSED_TILES=1 SEGMM_DEN=1`` and for 1 epoch
   with ``FUSED_TILES=1 GLOBAL_MAX=0`` (K7rm ×2 a forward); the launches
   against the counts per train step and eval forward that phase 4
   confirmed, a CSV row with finite losses and a checkpoint per run;
7. serve: ``infer-baseline`` for GATConv at hidden 512 from the checkpoint
   phase 6 saved (K4 ×2 per forward), the same with ``FUSED_TILES=1``
   from the fused run's checkpoint (K7f ×2 per forward), and for GCNConv
   at hidden 512 from random weights (K1 and K3 ×2 per forward), whose
   full forward with kernels is held against the same forward with the
   plain versions (atol 1e-4);
8. curriculum: the FIT-GNN curriculum through the port's CLI on ``cuda``
   at hidden 512, every launch counter at 0 just before each run
   (``CURRICULUM``): ``train`` GCNConv ``Gc_train_2_Gs_infer`` for 2
   epochs, whose partition (host seconds, metanodes, the subgraph batch's
   (S, N_pad, E_pad)) is computed once and then taken from the port's
   cache by every later run; ``Gc_train_2_Gs_train`` in GD and in MB
   (``--batch_size 128``) for 1 + 1 epochs; ``Gs_train_2_Gs_infer`` for 1;
   GATConv ``Gc_train_2_Gs_infer`` for 1.  Each Gc run prints Gc's tiles
   and stragglers and launches the counts per train step and eval forward
   that phase 4 confirmed times its epochs; the Gs epochs and evals launch
   none.  Then ``infer`` from the first run's checkpoint (64 samples, no
   launches), printed beside phase 7's GCN ``infer-baseline`` row, and
   the batched Gs eval forward of the first 4,096 subgraphs on the card
   against the same forward on the CPU (GCN and GAT, tolerance as in
   phase 3);
9. curriculum buckets: the 1-hop halo partition (``--extra_node``) in
   size buckets (``--bucket_sizes``) through the port's CLI at hidden
   512, every launch counter at 0 just before each run (``phase_buckets``):
   GCN ``Gc_train_2_Gs_train`` for 3 + 2 epochs in GD, whose partition
   phase 17's ``save-graphs`` computed just before (each bucket's (S,
   N_pad, E_pad) and the padded rows, bucketed and with one pad, held
   within 1% of ``BUCKET_ROWS`` and ``SINGLE_PAD_ROWS``) and every run
   here takes from the cache (none partitions), and in MB, both
   with ``--fused_epochs --eval_chunk 8192 --checkpoint_every 1``; GAT
   ``Gc_train_2_Gs_infer --fused_epochs`` for 3; GCN ``Gc_train_2_Gs_infer``
   for 3 with and without ``--fused_epochs`` (the fused phase under
   ``torch.cuda.set_sync_debug_mode("error")``, as every fused phase here;
   the val losses, their best and the test loss within rtol 1e-4), and,
   since that mode does not see every synchronization, a probe: a fused
   run of 2 epochs behind ~0.5 s of ``torch.cuda._sleep`` must return to
   the host before half of it has passed; the GD
   run cut after its Gs epoch 0's checkpoint and taken up with
   ``--resume`` (test loss and metric within rtol 1e-3 of the
   uninterrupted run's: the card's atomics); each Gc phase launching the
   counts per train step and eval forward that phase 4 confirmed times
   its epochs, the Gs phases none; the fused Gc ms an epoch, the Gs epoch
   seconds and the peak device memory of each run; the eval of every
   bucket at once against the chunked one (peak memory of each); then
   ``infer --extra_node --bucket_sizes`` from the GD run's checkpoint (64
   samples, no launches, the samples of each bucket) beside phase 8's
   ``infer``;
10. SAGE and GIN, and layer-0 pre-aggregation (``phase_sage_gin_*``):
   ``build_optimized_graph`` for SAGEConv (``mean_nonself`` weights, not
   symmetric) and GINConv (``sum_nonself``), whose tiles and straggler
   edges must be GCN's; K3 then K1 on each at F=128 and 512, forward and
   on the transpose structures (``t_segmm``, ``bsr.transpose``), and K8
   from ``init`` on SAGE's ``use_diag`` diagonal blocks in both
   orientations, each against its plain version (tolerance as in phase 3)
   with its times beside phase 3's GCN rows; one SAGE and one GIN step
   (hidden 512, dropout off, seed-0 init) with kernels and with the plain
   versions (the loss and every gradient, GIN's 0-dim ``eps`` included),
   K1 ×3 and K3 ×3 a step and ×2 an eval forward; the pre-aggregated
   model (K1 and K3 ×1 at ingest, then ×2 a step and ×1 an eval forward)
   against the plain model's loss, gradients and forward; SAGE's step on
   its ``use_diag`` operator (K3, K8 and K1 ×3) against the default
   operator's.  Then through the CLI, every counter at 0 just before
   each run: ``train --baseline`` for SAGEConv and GINConv at hidden 512
   for 2 epochs, plain and with ``--preaggregate`` (launches against those
   counts, a finite CSV row, a checkpoint), ``infer-baseline`` from each
   checkpoint (the pre-aggregated one into the plain model; K1 and K3 ×2 a
   forward) with that forward held against the plain versions, the
   curriculum ``train`` ``Gc_train_2_Gs_train`` GD for 1 + 1 epochs on
   phase 8's cached partition (the Gc epoch's counts, none in the Gs
   phase), and ``infer`` from SAGE's checkpoint (64 samples, no launches);
11. bf16 tiles (``phase_bf16_*``): the bench graph's operators built with
   ``tile_dtype=torch.bfloat16`` (GCN's default, ``use_diag``,
   ``tile_group=2`` and ``use_rowwalk`` layouts, GAT's mask; their tile
   bytes against f32's); each bf16 form against its plain version on the
   same tiles at F=128 and 512 (K1, K2, K9, K10; K8 forward and
   transposed, with and without init; K7rm, K7f, K7bt's dx and K7s, these
   also bit for bit against their f32 forms on the mask in f32), with
   kernel, plain and library times and its bound (tiles at 2 bytes an
   entry) beside the f32 form's time and bound; the walk's edge cases (a
   NaN tile entry reaches its own row only in K1, K2, K9, K10 and K8 both
   ways; an inf that only masked-out entries reach stays out of K7f and
   K7bt's dx); then, every counter at 0
   just before each run, one GCN step and eval forward on each bf16
   operator (K1, K8, K9 or K10 in its bf16 form, K3) against the plain
   versions, eval forwards on the forward-only bf16 operator (K2), a GAT
   step under ``FUSED`` and one under ``FUSED_EXACT`` on the bf16 mask
   against the plain versions and the f32 mask's step; then through the
   CLI with ``--hybrid_bf16_tiles``: ``train --baseline`` for GCN, SAGE
   and GAT (``FUSED``) at hidden 512 for 2 epochs (the f32 runs' counts
   with every tile kernel in its bf16 form, so no f32 tile kernel
   launches; best losses beside the f32 runs' of phases 6 and 10), and
   the curriculum ``train`` GD for 1 + 1 epochs on phase 8's cached
   partition (Gc on bf16 tiles);
12. the cluster collapse and the ingest planner (``phase_cluster_*``):
   the bench graph's operators under ``cluster_agg`` 2048 (GCN), with
   ``cluster_agg_exact`` 4096, and under ``cluster_att`` 2048 (GAT), each
   with its N_pad (169,984), C, tiles, stragglers, table entries and the
   table's type and MiB; the static term on the card against float64 on
   the host; one training step on each (hidden 512, dropout off, seed-0
   init: GCN on the static operators, GAT on the attention one under the
   default switches and under ``FUSED_TILES=1 SEGMM_DEN=1 GLOBAL_MAX=0``,
   whose exact max folds the summary rows) with kernels and with the plain
   versions (the loss and every gradient), launching phase 4's counts (the
   collapse launches none of the port's kernels); then through the CLI,
   every counter at 0 just before each run: ``train --baseline
   --cluster_aggregation 2048`` (GCN) and ``--cluster_attention 2048``
   (GAT) for 2 epochs, ``train --baseline --auto_config`` (GCN; the
   planner's pick and predicted ms), and the curriculum ``train`` GD for 1
   + 1 epochs with ``--cluster_aggregation 2048 --fused_epochs`` on phase
   8's cached partition (the fused Gc phase under
   ``set_sync_debug_mode("error")``), each with its launches and a finite
   row;
13. the graph-level tasks (``phase_graph``, 50–70 s, 150 s at most):
   2,048 QM9-shaped molecules (9–29 atoms, 11 features; QM9's 130,831 cut
   for the host's per-molecule coarsening, which every ``train`` and
   ``infer`` call repeats) from the port's ``qm9_like_dataset`` written as
   ``qm9proxy`` (regression targets) and ``qm9proxycls`` (the 2-class
   label) ``<name>_graphs.npz`` caches; through the port's CLI at hidden
   512, 2 layers, ``--batch_size 128 --extra_node``, every counter at 0
   just before each run: ``train --task graph_reg`` GCN
   ``Gc_train_2_Gs_train`` for 2 + 2 epochs, ``train --task graph_cls``
   GAT ``Gc_train_2_Gs_infer`` for 2, and ``infer --task graph_reg`` (256
   molecules, the Gs and Gc rows) from the first run's checkpoint; the
   host ms a molecule of ``prepare_graph_sample``, the collation seconds,
   the chunk's shapes (the Gc view on the per-edge branch, the Gs view on
   the dense batched one), the Gc and Gs epoch seconds, the peak device
   memory, each CSV row (finite), both views' ``avg_inf_time`` and
   ``avg_inf_time_device``, and no launch of the port's kernels (the JAX
   graph path reaches no Pallas kernel); then one train chunk's forward in
   both views on the card against the CPU with each run's saved
   parameters (tolerance as in phase 3);
14. tiles of edge 256 (``phase_block_*``, ~60 s): the bench graph's GCN
   operators built by ``build_hybrid(block=256)`` on phase 3's node order,
   as ``bench.py`` composes them (threshold 48; threshold 192 with
   ``use_diag``; threshold 48 with ``tile_group=2``), their tiles,
   diagonal blocks and stragglers beside the split expected, and each
   direction's live 128-wide quadrants (its occupancy words, checked
   against the tiles); K1 (forward and on the transpose), K2 and K9 (also
   on the transpose at 512) and K8 (both orientations, from init and from
   zero) at edge 256 on f32 and bf16 tiles at F=128 and 512, each against
   its plain version (tolerance as in phase 3) with its kernel, plain and
   library times and its bound; K1, K2 and K9 walk the live quadrants of
   the words and are also held bit for bit against the walk without words
   (timed beside them) and bounded a second time over the live quadrants,
   the slabs they reach and the output; then, every counter at
   0 just before each run, one eval forward and one ``gc_train_step`` of
   GCN at hidden 512 with K11's dropout on each operator in f32 and bf16,
   launching phase 4's and 5's counts at 128 (K1 / K8 / K9 in their
   ``@256`` forms) and held against the plain versions, two eval forwards
   on the forward-only operator (K2), and the step's ms on each f32
   operator beside the edge-128 operator's;
15. GAT's tiles of edge 256 (``phase_gat_block_*``, ~60 s): the bench
   graph's ``att_unit`` operators built by ``build_hybrid(block=256,
   semantics="att_unit")`` on phase 3's node order (threshold 48 on f32
   and on bf16 tiles; threshold 192 with ``cluster_att=2048``, the nodes
   padded to 169,984), their live tiles, stragglers and share of empty
   128-wide quadrants beside the split expected; K4 (``dyn_tiles``), K4ᵀ
   (``dyn_tiles_t`` on the transpose plan) and K5 (``dyn_grad_blocks``,
   one CTA a live quadrant of the plan's ``live`` list, bound at the
   tensor cores' TF32 rate for its three passes over the live quadrants)
   at edge 256 on ``pe``-like tile values at F=128 and 512, each
   against its plain version (tolerance as in phase 3) with its kernel,
   plain and library times (``torch.sparse.mm`` on the tiles' non-zeros;
   K5's ``torch.bmm`` on pre-gathered slabs, TF32 off) and its bound; K4
   and K4ᵀ walk the live quadrants of the plan's occupancy words (checked
   against the mask's), are also held bit for bit against the walk
   without words (timed beside them) and bounded over the live quadrants,
   the slabs they reach and the output, the bound over every quadrant of
   every tile beside it; K5's live quadrants bit for bit the full grid's
   and every other quadrant +0, the full grid timed beside it;
   then, every counter at 0 just before each run, one GAT
   ``gc_train_step`` and one eval forward at hidden 512 (dropout 0.5) on
   each operator under the default switches and under ``GLOBAL_MAX=0``,
   launching phase 4's GAT counts (K4, K4ᵀ, K5 in their ``@256`` forms)
   and held against the plain versions (the eval forward, the loss and
   every gradient); the threshold-48 step's loss and gradients, under
   PyTorch's deterministic algorithms, bit for bit with and without the
   plan's ``live`` (K5 on the full grid); and the step's ms on each
   operator beside the edge-128 GAT operator's, in one call;
16. GAT's fused tile attention at edge 256 (``phase_gat_fused_block_*``):
   on phase 15's threshold-48 operator, f32 and bf16 masks, K7rm
   (``att_rowmax``, bit for bit), K7f (``att_fwd``), K7bt's ``dx`` walk,
   the score pass K7s (partials (K, 2·256)) and K7sums at F=128 and 512,
   each against its plain version (tolerance as in phase 3; two launches
   of K7s + K7sums bit-equal; each bf16 form bit for bit its f32 form),
   with kernel, plain and two-stage times (the two-stage path at 256) and
   its bound, K7f, K7bt's ``dx`` (on the plan's words, ``words`` and
   ``t_words``), K7s (on its ``live`` list) and K7sums (the live
   quadrants' partials of ``words`` and ``t_words``, on each mask's pass)
   also bit for bit the launches without them (timed beside them), and
   the fused outputs and
   gradients against the two-stage path at 256; then, every counter at 0
   just before each run, one fused
   GAT ``gc_train_step`` and one eval forward at hidden 512 (dropout 0.5)
   on the threshold-48 operator under ``FUSED`` and ``FUSED_EXACT`` (f32
   and bf16 masks) and on the collapsed one under phase 12's ``FUSED``
   with ``GLOBAL_MAX=0``, launching the same mode's counts at 128 (the
   tile kernels in their ``@256`` forms) and held against the plain
   versions; and the fused step's ms on each operator beside the edge-128
   operator's, in one call;
17. the ``stats``, ``save-graphs`` and ``memory`` subcommands through the
   port's CLI on ``cuda`` (``phase_tools_*``), no launch: ``stats`` on the
   bench graph (its row: sizes, 40 classes, the homophily measures in
   [0, 1]); before phase 9, ``save-graphs`` with phase 9's partition flags
   (``--extra_node --bucket_sizes``) computes the partition into the
   port's cache (counted) and ``memory`` on the same flags loads it
   (never partitions), its two rows the byte accounting of that
   partition; after phase 13, ``memory --task graph_cls --extra_node`` on
   its 2,048 molecules (the first chunk's Gs and Gc views on the card, the
   largest molecule's row against the dataset's arrays); every row
   printed;
18. GAT's tile opt-ins and diagnostic switches (``phase_gat_optins``):
   the ``att_unit`` operators of ``use_diag`` (edges 128 and 256, f32 and
   bf16 masks), ``tile_group=2`` (128 and 256) and ``use_rowwalk`` (128)
   at threshold 48 on phase 3's order, their structure checked (no
   diagonal tile beside the diagonal blocks, even group runs, a plan
   except on the row walk, at 256 the plan's words, transposes and live
   list the tiles' own with word 0 on pads and fillers); on each, under
   its modes (two-stage, ``FUSED``, ``FUSED_EXACT``), one GAT
   ``gc_train_step`` at hidden 512 (dropout 0.5) and one eval forward,
   every counter at 0 just before, launching the mode's counts (K4, K4ᵀ,
   K5 or the K7 forms, ``@256`` at 256, bf16 forms on bf16 masks; on the
   row walk K6 and K3w alone) and held against the plain versions; at
   256 the two-stage and ``FUSED_EXACT`` steps with the plan's words and
   live list against the same steps without them and against themselves,
   bit for bit, under deterministic algorithms; then each diagnostic
   switch setting (``FUSED_BWD``, ``FUSED_BWD`` + ``FUSED_SORTED_DH``,
   ``SORTED_NUM`` + ``SORTED_SRC``) on the default operator at 128: the
   default path's launches, the straggler primitive it selects, held
   against the plain versions and the default step; and the step's ms on
   every operator and setting beside the edge-128 and phase 15's edge-256
   threshold-48 operators, two-stage, fused and under each switch;
19. the hierarchical layer (``parallel/hierarchical.py``) in a one-rank
   NCCL world, H = D = 1: the bench graph in phase 3's Leiden order,
   ``shard_graph`` under each layer's semantics and ``build_hier_plan``
   at its threshold of 150 (the interior's tiles and stragglers printed,
   and the tiles it and the single-device operator do not share);
   for GCN, SAGE, GIN and GAT at hidden 512 from the same seed-0
   parameters, the ``HierNodeModel``'s eval forward, its eval loss and
   metric and one ``hier_train_step``'s loss and gradients (dropout off)
   on the kernels, held against the single-device ``NodeModel`` on its
   operator at threshold 150 on the plain versions (no launch; GIN's
   ReLU masks replayed, as in phase 10); the
   step's and the eval's launches (K1 ×3 and K3 ×3 a
   step, ×2 each an eval, for GCN, SAGE and GIN; none for GAT, whose
   interior takes the einsum tile branch without a plan) and their ms
   beside the single-device path's in the same call;
20. the distributed curriculum in a one-rank NCCL world, H = D = 1
   (``phase_dist_curriculum``), through the functions ``run_node_task``
   itself uses for it (``NodeTaskConfig(distributed=True)`` selects that
   path at one rank): phase 8's partition from the port's cache (a Gc of
   84,586 nodes, 84,759 subgraphs of N_pad 24), the Gc in
   ``optimize_coarse``'s Leiden order (at one rank the placement keeps
   the Gc's order, in which no block reaches the threshold; the count of
   such blocks in the partition's order printed), with the
   single-device operator at the hier interior's threshold of 150 as the
   reference; the hierarchical Gc phase of GCN (``_make_hier_gc_steps``:
   the interior's tiles and stragglers printed) at hidden 512 from seed-0
   parameters, dropout off: one eval and one step with the kernels (K1 ×2
   and K3 ×2 an eval, ×3 each a step) held against ``gc_eval_step`` /
   ``gc_train_step`` on the coarse graph under the plain versions (no
   launch): loss, metric and every gradient, and their ms beside each
   other; GAT's hier eval (no launch) against the per-edge single-device
   eval; the subgraph-sharded Gs GD step and MB epoch, each with a val
   eval (``_make_dist_steps``), against the single-device ones
   (``_gs_train_epoch``, ``_gs_eval``) on the same batch, one side at a
   time: the loss, the val (loss, metric), the (last step's) gradients
   and the parameters, whether each is bit for bit, no launch; then a
   2 + 2-epoch ``Gc_train_2_Gs_train`` through ``run_node_task``
   (dropout 0.5): its launches (the Gc epochs' alone), the hier Gc ms an
   epoch, the Gs seconds an epoch and the test eval's seconds beside
   phase 8's single-device figures;
21. the flat data mesh (``parallel/halo.py``, ``dist_model.py``,
   ``dist_train.py``) in a one-rank NCCL world (``phase_flat``): Leiden
   on the bench graph and ``placement_by_community`` (the identity at one
   shard), ``shard_graph`` under each layer's semantics and
   ``build_halo_plan`` (E_loc, K = 8 and no boundary row printed); for
   GCN, SAGE, GIN and GAT at hidden 512 from the same seed-0 parameters,
   dropout off: the ``DistNodeModel``'s eval forward and test eval, the
   ``DistNodeModelHalo``'s test eval, one all-gather and one halo train
   step, every counter at 0 just before and none of the port's kernels
   launched; under PyTorch's deterministic algorithms the halo table's
   eval, loss, gradients and parameters bit for bit the all-gather
   table's; the forward, the eval and the step's loss and gradients held
   against ``NodeModel``'s ``gc_eval_step`` / ``gc_train_step`` on the
   shard's edges as a per-edge graph in the same node order (GIN's ReLU
   masks replayed, as in phase 10); the two steps' ms and edges/s beside
   that single-device step (GCN also beside phase 3's operator, K3 and
   K1); then ``scripts/torch_scaling_bench.py --devices 1`` as a process
   of its own (its P=1 line printed);
22. a Cora-shaped Planetoid raw set (``write_planetoid_cora``: 2,708
   nodes, 1,433 features, 7 classes, ``ind.cora.*`` pickles from seed 0)
   under the temp root, no npz cache: ``load_node_dataset`` reads it,
   then ``stats`` and ``train --baseline --dataset cora`` (hidden 512, 5
   epochs) through the port's CLI on ``cuda``, no launch, their rows
   checked, and still no cache afterwards;
23. tiles of f16, fp8 e4m3fn and fp8 e5m2 (``phase_tile_types``; run
   after phase 21, on phase 3's graph): for each type, GCN's ``use_diag``
   operator and GAT's ``att_unit`` one from ``build_hybrid(tile_dtype=
   ...)`` (threshold 48, K3 stragglers), their tiles byte for byte the
   f32 operator's cast (``cast_tiles``); on the card the tiles and the
   diagonal blocks are f32, the cast values widened; then, every counter
   at 0 just before, one eval forward and one train step at hidden 512
   (GCN with K11 dropout 0.5, GAT fused + K6 with dropout 0.5; seed-0
   weights) under deterministic algorithms: the f32 forms launched, as
   many as the same run on the operator widened on the host launches, and
   bit for bit that run; then the two steps' ms on f16 and e4m3 tiles
   beside f32, in one call;
24. the products proxy (``phase_products_ingest``, after phase 22):
   ``planted_products_graph(2,449,029)`` (degree 25, ~30.6 M directed
   edges) through ``build_graph``, which must take the C++ branch once:
   the generator's and the ingest's host seconds and the edge counts;
   then on the first 2.1 M input edges the C++ core against the numpy
   branch, canonicalised by ``lexsort`` (edges exactly, weights within
   rtol 1e-5);
25. the tooling (``phase_tooling``, after phase 23):
   ``measure_spmm_roofline()`` at its defaults (the achieved GB/s against
   3,350) and a ``device_trace`` of three hybrid SpMMs on phase 3's
   operator, whose Chrome trace must hold the card's kernels;
26. bf16 activations, the conv stack's ``dtype=torch.bfloat16`` (after
   phase 11, on its bf16 operators and phase 3's): K1a (K1 on bf16 ``x``
   and ``init``, f32 tiles) and K1bfa (bf16 tiles) on ``bsr`` and
   ``bsr.transpose``, K3a on the GCN straggler CSR both ways, K3wa and
   K6a (K3w, K6) on GAT's, at F=128 and 512, and K11a at (N_pad, 512),
   each against its plain version (``compare_bf16``: rtol 2⁻⁶, two bf16
   steps; K6a's den and K11a exactly, K11a with the f32 form's mask) and
   twice bit-equal, timed beside its f32-activation form with its bound
   and library call; each widened form once (K2, K9, K10, K8, K7f, K7bt's
   ``dx``, K7s, K1 at 256: its f32 form launched, on the widened operands
   bit for bit, against its plain version); then three
   steps through the library, every counter at 0 just before each
   counted step and eval forward: ``bench.py``'s bf16 GCN (pre-aggregated
   layer 0, bf16 tiles, bit dropout: K3a 3, K1bfa 3 and no f32 K1 or
   K3), the bf16 GCN + K11 step (K3 2, K1 2 on layer 0's f32 input, K3a
   3, K1a 3, K11a 4) and the bf16 fused + K6 GAT step on the bf16 mask
   (K7fbf 4, K7btbf 1, K7sbf 2, K7sums 2, K6a 4, K3wa 1), each held
   against the plain versions
   (loss 1e-2 relative, gradients 5e-2·max|ref|, eval forward
   2e-2·max(1, max|ref|)) and timed beside its f32 twin;
27. GAT's two-stage tile path on bf16 activations (after phase 18):
   ``bench.py``'s GAT operator (``build_hybrid(..., semantics="att_unit",
   tile_dtype=torch.bfloat16, min_block_edges=32, use_segmm=True,
   block=128)``) and phase 15's threshold-48 operator with bf16 tiles at
   edge 256: K4a (``dyn_tiles``), K4ᵀa (``dyn_tiles_t``) and K5a
   (``dyn_grad_blocks``) on bf16 ``pe`` values and bf16 activations at
   F=128 and 512, each against its plain version (``compare_bf16``),
   twice bit-equal, at 256 bit for bit the walks without words and the
   full grid on the live quadrants (+0 elsewhere), timed beside the f32
   form on the same values and the widened route it replaces, with its
   bound (bf16 bytes; K5a's bf16 tensor-core rate) and library call; then
   ``NodeModel("GATConv", 128, 512, 2, 40, dtype=torch.bfloat16,
   dropout_rate=0.5, bit_dropout=True)``'s eval forward and
   ``gc_train_step`` on each operator, every counter at 0 just before:
   K4a 4, K4ᵀa 1, K5a 2 (``@256`` at 256), no f32 K4, K4ᵀ or K5, no
   ``kernels.widened`` call, the widths 128 and 512 in bf16, held against
   the plain versions as phase 26's steps and timed beside the f32 twin;
28. one JSON line with every kernel's numbers, the bf16 forms, the
   bf16-activation forms (``K1a``, ``K1bfa``, ``K3a``, ``K3wa``, ``K6a``,
   ``K11a``, ``K4a``, ``K4Ta``, ``K5a`` and their @256 forms) and the
   forms at edge 256 (``K1@256``, ``K1bf@256``, ``K4@256``, ``K7f@256``,
   ...) as their own entries (launches summed over the main-path phases 5
   to 27, per phase beside them; K3, K3w, K6, K5, K7f, K7bt, K7s and
   K7sums, their bf16-activation forms, K4a, K4ᵀa and K5a, and K1, K2,
   K9, K4, K4ᵀ (their walks of the live quadrants), K5, K7f, K7bt, K7s
   and K7sums at 256, with their ``ptxas`` register and spill counts),
   then the ``ok`` line.

The JAX package's environment switches are set in ``os.environ`` for one
phase and restored after it; the earlier phases must launch none of K6
and K7, the CLI phases none of the opt-in kernels, no phase before 11
a bf16 form, and no phase but 26 and 27 a bf16-activation form.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from unittest import mock

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12        # f32 outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12      # TF32 on the tensor cores
PEAK_BF16_FLOP_PER_S = 989e12      # bf16 on the tensor cores

# bench.py's graph
NUM_NODES = 169_344
COMM = 128
AVG_DEGREE = 7
NUM_FEATURES = 128
NUM_CLASSES = 40
INTERNAL = 0.85
HIDDEN = 512

# the JAX package's ingest of this graph on the TPU (BENCH_r05.json)
REF_TILES = 2_192
REF_STRAGGLERS = 232_718

RTOL = 1e-4
SLOPE = 0.2                        # GATConv's LeakyReLU slope

# the JAX package's tile_gat switches of the fused phases
FUSED = {"FITGNN_GAT_FUSED_TILES": "1", "FITGNN_GAT_SEGMM_DEN": "1"}
FUSED_EXACT = {"FITGNN_GAT_FUSED_TILES": "1", "FITGNN_GAT_GLOBAL_MAX": "0"}
FUSED_ONLY = {"FITGNN_GAT_FUSED_TILES": "1"}


def make_graph():
    """bench.py's community graph generator (seed 0)."""
    rng = np.random.default_rng(0)
    e = NUM_NODES * AVG_DEGREE // 2
    receivers = rng.integers(0, NUM_NODES, e, dtype=np.int64)
    comm = receivers // COMM
    s_in = comm * COMM + rng.integers(0, COMM, e)
    s_out = rng.integers(0, NUM_NODES, e)
    senders = np.where(rng.random(e) < INTERNAL, s_in, s_out)
    keep = senders != receivers
    senders, receivers = senders[keep], receivers[keep]
    perm = rng.permutation(NUM_NODES)
    senders, receivers = perm[senders], perm[receivers]
    x = rng.standard_normal((NUM_NODES, NUM_FEATURES)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, NUM_NODES).astype(np.int32)
    train = rng.random(NUM_NODES) < 0.5
    return x, senders, receivers, y, train


def walk_args(kernel_name: str):
    """(TRANS, INIT, DIAG, hook) of a ``sparse::walk_kernel<TRANS, INIT,
    VEC, DIAG, V, T, ROUND_X, QUAD>`` launch by its demangled name, ``hook``
    the value hook's name without its namespace ("Plain", K7f's
    "FwdScores", K7bt's "DxScores"), or None for any other kernel (the
    profile scripts group the walk's users by these; the tile type T and
    ROUND_X, the bf16 forms', and QUAD, the quadrant walk of tiles wider
    than 128, do not change the group)."""
    m = re.search(r"sparse::walk_kernel<(\w+),(\w+),(\w+),(\w+),"
                  r"(?:\w+::)*(\w+)(?:,\w+)*>",
                  kernel_name.replace(" ", ""))
    if m is None:
        return None
    trans, init, _, diag = (v in ("true", "1") for v in m.groups()[:4])
    return trans, init, diag, m.group(5)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """``cuda_ms`` with the stream held busy (``torch.cuda._sleep``) while
    the host enqueues the launches, so that the wrapper's host time between
    two launches does not count: the device time of a kernel shorter than
    its wrapper's host work."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def segmm_times(fn) -> dict:
    """The straggler sum's times (K3, K3w, K6): ``ms`` its device time
    (the kernel alone: its wrapper launches nothing else) and
    ``wrapper_ms`` with the wrapper's host work."""
    return {"ms": device_ms(fn, 20), "wrapper_ms": cuda_ms(fn, 20)}


def segmm_note(sh: dict) -> str:
    from fitgnn_tpu_torch.ops.coo_segmm import launch_shape
    return (f" wrapper_ms={sh['wrapper_ms']:.4f} launch shape "
            f"{launch_shape(sh['F'])}")


def compare(name: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got - ref).abs()
    scale = float(ref.abs().max())
    atol = 1e-4 * scale
    max_abs = float(diff.max())
    max_rel = float((diff / ref.abs().clamp_min(atol if atol > 0 else 1e-30)
                     ).max())
    ok = bool((diff <= atol + RTOL * ref.abs()).all())
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(atol={atol:.3e}, rtol={RTOL})")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel}


@contextlib.contextmanager
def switches(env: dict):
    """Set the JAX package's switches for one phase, restore after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bound(bytes_: float, ops: float,
          flop_per_s: float = PEAK_F32_FLOP_PER_S) -> tuple:
    """The least time in ms for ``bytes_`` over the memory rate and ``ops``
    over ``flop_per_s`` (the unit the kernel computes in), the larger of
    the two, and which it is."""
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_entries(log_path: str) -> list:
    """(kernel, registers, spilled bytes) of each entry function in a
    ``ptxas -v`` log; names demangled by ``c++filt`` where it is found,
    without their parameter lists."""
    found, name, spill = [], None, 0
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                found.append([name, int(m.group(1)), spill])
                name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            e[0] for e in found), capture_output=True, text=True,
            check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = [e[0] for e in found]
    for e, n in zip(found, names):
        n = n.replace("(anonymous namespace)::", "")
        e[0] = re.sub(r"^void ", "", n.split("(")[0])
    return [tuple(e) for e in found]


def phase_build() -> list:
    """Builds every library; returns (library, kernel, registers, spilled
    bytes) of each kernel, which it prints."""
    from fitgnn_tpu_torch.ops import kernels
    from fitgnn_tpu_torch.partition.community import LEIDEN
    from fitgnn_tpu_torch.utils.build import build
    t0 = time.perf_counter()
    built = build([*kernels.TARGETS, LEIDEN])
    print(f"build: {built} in {time.perf_counter() - t0:.1f} s")
    regs = []
    for t in kernels.TARGETS:
        for kernel, n, spill in ptxas_entries(t.log_path):
            print(f"  {t.name}: {kernel}: {n} registers, {spill} bytes "
                  "spilled")
            regs.append((t.name, kernel, n, spill))
    return regs


def phase_small_reference(device) -> None:
    """Hybrid SpMM (K3 then K1) on a small community graph against a dense
    float64 product on the host."""
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm
    rng = np.random.default_rng(1)
    n, e, f = 1024, 12_000, 128
    r = np.sort(rng.integers(0, n, e))
    s = np.where(rng.random(e) < 0.8, (r // 128) * 128
                 + rng.integers(0, 128, e), rng.integers(0, n, e))
    w = rng.random(e).astype(np.float32)
    h = build_hybrid(s, r, w, n, min_block_edges=48, use_segmm=True)
    check(h.bsr is not None and h.num_coo_edges > 1,
          "small reference graph must have tiles and stragglers")
    x = rng.standard_normal((n, f)).astype(np.float32)
    a = np.zeros((n, n))
    np.add.at(a, (r, s), w.astype(np.float64))
    ref = torch.from_numpy((a @ x.astype(np.float64)).astype(np.float32))
    with torch.inference_mode():
        got = hybrid_spmm(h.to(device), torch.from_numpy(x).to(device)).cpu()
    compare("hybrid_spmm small graph vs dense float64", got, ref)


def tile_csr(b, n: int) -> tuple:
    """The CSR of a BCSR operator's tile non-zeros (the library yardstick's
    operand) and their count."""
    nz = b.blocks.nonzero()
    rows = b.rows.long()[nz[:, 0]] * b.block + nz[:, 1]
    cols = b.cols.long()[nz[:, 0]] * b.block + nz[:, 2]
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), b.blocks[nz[:, 0], nz[:, 1], nz[:, 2]],
        (n, n)).coalesce().to_sparse_csr()
    return csr, nz.shape[0]


def k1_k3_rows(b, m, n: int, xs: dict, tag: str = "") -> dict:
    """K3 (``segmm_spmm``) on the straggler CSR ``m``, then K1
    (``bsr_spmm_acc``) on the tiles ``b`` from K3's output, at each width
    of ``xs`` ({F: x}), each against its plain version, with kernel, plain
    and library times and the bound from bytes and operations: phase 3's
    rows on the GCN operator, phase 10's on SAGE's and GIN's, forward and
    on the transpose structures (``tag`` names them)."""
    from fitgnn_tpu_torch.ops.bsr_spmm import bsr_spmm_acc, bsr_spmm_acc_plain
    from fitgnn_tpu_torch.ops.coo_segmm import segmm_spmm, segmm_spmm_plain

    tiles_all = b.nnz_blocks
    nz_tile = (b.blocks.reshape(tiles_all, -1) != 0).any(dim=1)
    tiles = int(nz_tile.sum())
    tile_edges = int((b.blocks != 0).sum())
    live = m.weights != 0
    e = int(live.sum())
    # library yardsticks: the same products through torch.sparse (cuSPARSE)
    a_tiles, _ = tile_csr(b, n)
    a_str = torch.sparse_csr_tensor(m.row_ptr, m.senders, m.weights, (n, n))
    uniq_cols = int(torch.unique(b.cols[nz_tile]).numel())
    uniq_senders = int(torch.unique(m.senders[live]).numel())
    shapes = {"K1": [], "K3": []}
    with torch.inference_mode():
        for feat, x in xs.items():
            name = f"{tag} F={feat}" if tag else f"F={feat}"
            print(f"{name}:")
            init = segmm_spmm_plain(m, x)
            k3 = segmm_spmm(m, x)
            k3_again = segmm_spmm(m, x)
            torch.cuda.synchronize()
            err3 = compare(f"K3 segmm_spmm {name}", k3, init)
            check(torch.equal(k3, k3_again), f"K3 {name}: two launches "
                  "differ")
            del k3_again
            k1 = bsr_spmm_acc(b, x, init)
            p1 = bsr_spmm_acc_plain(b, x, init)
            torch.cuda.synchronize()
            err1 = compare(f"K1 bsr_spmm_acc {name}", k1, p1)
            # yardsticks: one PyTorch call each computing the same function
            def lib1():
                return torch.sparse.addmm(init, a_tiles, x)

            def lib3():
                return torch.sparse.mm(a_str, x)

            compare(f"K1 library torch.sparse.addmm {name}", lib1(), p1)
            compare(f"K3 library torch.sparse.mm {name}", lib3(), init)

            # K1's function needs 2 FLOPs per tile non-zero and feature,
            # which is what the kernel's walk of the non-zeros does
            b1, by1 = bound(
                tiles * 128 * 128 * 4 + (2 * tiles_all + b.num_row_blocks + 1)
                * 4 + uniq_cols * 128 * feat * 4 + 2 * n * feat * 4,
                2.0 * tile_edges * feat)
            b3, by3 = bound((n + 1) * 4 + e * 8 + uniq_senders * feat * 4
                            + n * feat * 4, 2.0 * e * feat)
            extra = {"operator": tag} if tag else {}
            shapes["K1"].append(dict(
                F=feat, **extra, **err1, bound_ms=b1, bound_by=by1,
                ms=cuda_ms(lambda: bsr_spmm_acc(b, x, init), 20),
                plain_ms=cuda_ms(lambda: bsr_spmm_acc_plain(b, x, init), 5),
                library_ms=cuda_ms(lib1, 20)))
            shapes["K3"].append(dict(
                F=feat, **extra, **err3, bound_ms=b3, bound_by=by3,
                **segmm_times(lambda: segmm_spmm(m, x)),
                plain_ms=cuda_ms(lambda: segmm_spmm_plain(m, x), 20),
                library_ms=cuda_ms(lib3, 20)))
            for k in ("K1", "K3"):
                s = shapes[k][-1]
                print(f"  {k} {name}: kernel_ms={s['ms']:.4f} "
                      f"plain_ms={s['plain_ms']:.4f} "
                      f"library_ms={s['library_ms']:.4f} "
                      f"bound_ms={s['bound_ms']:.4f} ({s['bound_by']})"
                      + (segmm_note(s) if k == "K3" else ""))
    return shapes


def phase_kernels(device, ds) -> tuple:
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph

    t0 = time.perf_counter()
    g, order = build_optimized_graph(ds.x, ds.senders, ds.receivers,
                                     y=ds.y, train_mask=ds.train_mask,
                                     layer_name="GCNConv", seed=0)
    print(f"ingest (Leiden + hybrid build): {time.perf_counter() - t0:.1f} s")
    h = g.aux
    tiles_all = h.bsr.nnz_blocks
    nz_tile = (h.bsr.blocks.reshape(tiles_all, -1) != 0).any(dim=1)
    tiles = int(nz_tile.sum())
    stragglers = int((h.weights != 0).sum())
    tile_edges = int((h.bsr.blocks != 0).sum())
    print(f"edges: {int(g.n_edge)} (tile edges {tile_edges}, tile occupancy "
          f"{tile_edges / (tiles * 128 * 128):.4f})")
    print(f"hybrid: N_pad={g.num_nodes_padded} tiles={tiles} "
          f"(+{tiles_all - tiles} coverage fillers) stragglers={stragglers} "
          f"(reference ingest: {REF_TILES} tiles, {REF_STRAGGLERS} "
          f"stragglers; diff {tiles - REF_TILES:+d} / "
          f"{stragglers - REF_STRAGGLERS:+d})")

    gd = g.to(device)
    hd = gd.aux
    n = g.num_nodes_padded
    gen = torch.Generator(device=device).manual_seed(0)
    xs = {NUM_FEATURES: gd.x,
          HIDDEN: torch.randn((n, HIDDEN), generator=gen, device=device)}
    shapes = k1_k3_rows(hd.bsr, hd.segmm, n, xs)
    return g, order, shapes


def counters() -> dict:
    """Every kernel form of the path, by the ID of the TPU kernel it
    replaces (a bf16 form's ID ends in "bf"): (its wrapper, the wrapper's
    count of that form's launches)."""
    from fitgnn_tpu_torch.ops.bsr_dynamic import (dyn_grad_blocks,
                                                  dyn_tiles, dyn_tiles_t)
    from fitgnn_tpu_torch.ops import att_bsr
    from fitgnn_tpu_torch.ops.bsr_spmm import (bsr_spmm_acc, bsr_spmm_fwd,
                                               bsr_spmm_grouped,
                                               bsr_spmm_rowwalk)
    from fitgnn_tpu_torch.ops.coo_segmm import (segmm_spmm,
                                                segmm_weighted_den_raw,
                                                segmm_weighted_raw)
    from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm
    from fitgnn_tpu_torch.ops.dropout import philox_dropout
    f32 = {"K1": bsr_spmm_acc, "K3": segmm_spmm, "K4": dyn_tiles,
           "K4T": dyn_tiles_t, "K5": dyn_grad_blocks,
           "K3w": segmm_weighted_raw, "K6": segmm_weighted_den_raw,
           "K7rm": att_bsr.att_rowmax, "K7f": att_bsr.att_fwd,
           "K7bt": att_bsr.att_bwd_t, "K7s": att_bsr.att_bwd_scores,
           "K7sums": att_bsr.att_sums,
           "K2": bsr_spmm_fwd, "K8": diag_spmm, "K9": bsr_spmm_grouped,
           "K10": bsr_spmm_rowwalk, "K11": philox_dropout}
    # the bf16-activation forms (phase 26): K1a on f32 tiles, K1bfa on
    # bf16 tiles, K3a / K3wa / K6a the straggler sum's, K11a the dropout's;
    # (phase 27) K4a, K4Ta and K5a the dynamic tiles'
    act = {"K1a": (bsr_spmm_acc, "launches_a"),
           "K1bfa": (bsr_spmm_acc, "launches_bfa"),
           "K3a": (segmm_spmm, "launches_a"),
           "K3wa": (segmm_weighted_raw, "launches_a"),
           "K6a": (segmm_weighted_den_raw, "launches_a"),
           "K11a": (philox_dropout, "launches_a"),
           "K4a": (dyn_tiles, "launches_a"),
           "K4Ta": (dyn_tiles_t, "launches_a"),
           "K5a": (dyn_grad_blocks, "launches_a")}
    return {**{k: (fn, "launches") for k, fn in f32.items()},
            **{BF[k]: (f32[k], "launches_bf16") for k in BF}, **act}


# the kernels with a bf16 form (bf16 tiles), and its ID
BF = {k: f"{k}bf" for k in ("K1", "K2", "K8", "K9", "K10", "K7rm", "K7f",
                            "K7bt", "K7s")}


def bf16_counts(counts: dict) -> dict:
    """Launch counts of an f32-tile run, its tile kernels in their bf16
    forms: what the same run on bf16 tiles launches."""
    return {BF.get(k, k): v for k, v in counts.items()}


def reset_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def dyn_live_quadrants(b, plan) -> tuple:
    """The live 128-wide quadrants of a dynamic plan's occupancy words and
    the distinct 128-row slabs they reach in each walk: (quadrants, slabs
    of the forward walk, slabs of the transpose walk).  Fails unless the
    words are the mask's own (``live_quadrants``) and each transpose
    slot's word is that of its tile transposed (0 on a filler)."""
    from fitgnn_tpu_torch.ops.bsr_spmm import quad_words

    quads, slabs = live_quadrants(b)
    check(torch.equal(plan.words, b.quad_bits),
          "the plan's words are not the mask's")
    tiles = b.blocks.index_select(0, plan.t_sel.long()).transpose(1, 2)
    check(torch.equal(plan.t_words, torch.where(
        plan.t_scale != 0, quad_words(tiles, b.block), 0)),
        "the plan's transpose words are not its tiles' transposed")
    del tiles
    nq = b.block // 128
    bits = (plan.words.unsqueeze(1) >> torch.arange(
        nq * nq, device=plan.words.device)) & 1
    k, ij = bits.nonzero(as_tuple=True)
    t_slabs = torch.unique(b.rows.long()[k] * nq + ij // nq).numel()
    return quads, slabs, t_slabs


def dyn_kernel_rows(device, hd, gen, tag: str = "") -> dict:
    """K4, K4ᵀ (on the transpose plan) and K5 on the tiles of ``hd``, an
    ``att_unit`` operator on the card, at the tiles' edge, with
    attention-like values (positive on the mask, zero elsewhere) at F=128
    and 512: each against its plain version, with its kernel, plain and
    library times and its bound.  Where the plan has occupancy words (edge
    256), K4 and K4ᵀ walk their live quadrants: each also bit for bit
    against the walk without words (timed beside it, ``nowords_ms``), with
    its bound over the live quadrants, the slabs they reach and the
    output, and the bound over every quadrant of every tile beside it
    (``bound_tiles_ms``); K5 runs on the plan's live list: its live
    quadrants bit for bit the full grid's (timed beside it, ``nowords_ms``)
    and every other quadrant +0, bound over the live quadrants' products
    with the tile bound beside it.  Returns the rows by ID, ``tag`` ("" or
    "@256") after each."""
    from fitgnn_tpu_torch.ops.bsr_dynamic import (
        dyn_grad_blocks, dyn_grad_blocks_plain, dyn_tiles, dyn_tiles_plain,
        dyn_tiles_t, dyn_tiles_t_plain)

    b, plan = hd.bsr, hd.dyn_plan
    n, edge = hd.num_nodes, b.block
    nb, k_all = n // edge, b.nnz_blocks
    words = plan.words is not None
    nowords = dataclasses.replace(plan, words=None, t_words=None)
    if words:
        quads, q_slabs, qt_slabs = dyn_live_quadrants(b, plan)
        print(f"K4{tag}, K4T{tag}: {quads} live 128-wide quadrants of "
              f"{k_all * (edge // 128) ** 2} in the occupancy words; "
              f"{q_slabs} / {qt_slabs} distinct slabs they reach")
    mask = b.blocks > 0
    blocks = torch.where(mask, torch.rand(mask.shape, generator=gen,
                                          device=device), 0.0)
    nnz = int(mask.sum())
    nz = mask.nonzero()
    a_rows = b.rows.long()[nz[:, 0]] * edge + nz[:, 1]
    a_cols = b.cols.long()[nz[:, 0]] * edge + nz[:, 2]
    a_vals = blocks[nz[:, 0], nz[:, 1], nz[:, 2]]
    a_csr = torch.sparse_coo_tensor(torch.stack([a_rows, a_cols]), a_vals,
                                    (n, n)).coalesce().to_sparse_csr()
    a_t_csr = torch.sparse_coo_tensor(torch.stack([a_cols, a_rows]), a_vals,
                                      (n, n)).coalesce().to_sparse_csr()
    del mask, nz, a_rows, a_cols, a_vals
    uniq_cols = int(torch.unique(b.cols).numel())
    uniq_rows = int(torch.unique(b.rows).numel())
    tile_bytes = k_all * edge * edge * 4
    idx_bytes = (2 * k_all + nb + 1) * 4
    out = {f"{k}{tag}": [] for k in ("K4", "K4T", "K5")}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            for feat in (NUM_FEATURES, HIDDEN):
                x = torch.randn((n, feat), generator=gen, device=device)
                gr = torch.randn((n, feat), generator=gen, device=device)
                print(f"F={feat}{' at edge ' + str(edge) if tag else ''}:")
                k4 = dyn_tiles(b.rows, b.cols, plan, blocks, x)
                p4 = dyn_tiles_plain(b.rows, b.cols, plan, blocks, x)
                k4t = dyn_tiles_t(plan, blocks, gr)
                p4t = dyn_tiles_t_plain(plan, blocks, gr)
                torch.cuda.synchronize()
                err4 = compare(f"K4{tag} dyn_tiles F={feat}", k4, p4)
                err4t = compare(f"K4T{tag} dyn_tiles_t F={feat}", k4t, p4t)
                if words:
                    check(torch.equal(k4, dyn_tiles(b.rows, b.cols, nowords,
                                                    blocks, x)),
                          f"K4{tag} F={feat}: the walk with occupancy "
                          "words is not the walk without them bit for bit")
                    check(torch.equal(k4t, dyn_tiles_t(nowords, blocks, gr)),
                          f"K4T{tag} F={feat}: the walk with occupancy "
                          "words is not the walk without them bit for bit")
                compare(f"K4{tag} library torch.sparse.mm F={feat}",
                        torch.sparse.mm(a_csr, x), p4)
                compare(f"K4T{tag} library torch.sparse.mm F={feat}",
                        torch.sparse.mm(a_t_csr, gr), p4t)
                del k4, p4, k4t, p4t
                k5 = dyn_grad_blocks(b.rows, b.cols, gr, x, edge,
                                     plan.live)
                p5 = dyn_grad_blocks_plain(b.rows, b.cols, gr, x, edge,
                                           plan.live)
                torch.cuda.synchronize()
                err5 = compare(f"K5{tag} dyn_grad_blocks F={feat}", k5, p5)
                del p5
                if words:
                    # the live quadrants the full grid's, the others +0
                    full = dyn_grad_blocks(b.rows, b.cols, gr, x, edge)
                    nq = edge // 128
                    keep = torch.zeros(k_all * nq * nq, dtype=torch.bool,
                                       device=device)
                    keep[plan.live.long()] = True

                    def quads_of(t):
                        return t.reshape(k_all, nq, 128, nq, 128).transpose(
                            2, 3).reshape(-1, 128, 128)

                    q5, qf = quads_of(k5), quads_of(full)
                    check(torch.equal(q5[keep], qf[keep]),
                          f"K5{tag} F={feat}: a live quadrant is not the "
                          "full grid's bit for bit")
                    dead = q5[~keep]
                    check(bool((dead == 0).all())
                          and not bool(dead.signbit().any()),
                          f"K5{tag} F={feat}: an empty quadrant is not +0")
                    print(f"  K5{tag} F={feat}: {int(keep.sum())} live "
                          "quadrants bit for bit the full grid's, "
                          f"{int((~keep).sum())} empty ones +0")
                    del full, q5, qf, dead, keep
                del k5
                # K4 and K4ᵀ read every tile (at 256 all four quadrants),
                # the slabs of the distinct input blocks and write the
                # output once; 2 FLOPs per tile non-zero and feature
                b4, by4 = bound(tile_bytes + idx_bytes
                                + uniq_cols * edge * feat * 4 + n * feat * 4,
                                2.0 * nnz * feat)
                b4t, by4t = bound(tile_bytes + (3 * plan.t_sel.numel()
                                                + nb + 1) * 4
                                  + uniq_rows * edge * feat * 4
                                  + n * feat * 4, 2.0 * nnz * feat)
                live4 = {}
                if words:
                    # with the words: each live quadrant (64 KiB), the
                    # indices and words, the distinct 128-row slabs of the
                    # live quadrants and the output; the bounds above, over
                    # every quadrant of every tile, stay beside them
                    kt = plan.t_sel.numel()
                    bl4, byl4 = bound(
                        quads * 128 * 128 * 4 + (k_all + nb + 1) * 4
                        + k_all * 8 + q_slabs * 128 * feat * 4
                        + n * feat * 4, 2.0 * nnz * feat)
                    blt, bylt = bound(
                        quads * 128 * 128 * 4 + (2 * kt + nb + 1) * 4
                        + kt * 8 + qt_slabs * 128 * feat * 4
                        + n * feat * 4, 2.0 * nnz * feat)
                    live4 = {
                        "K4": dict(
                            bound_ms=bl4, bound_by=byl4, bound_tiles_ms=b4,
                            live_quadrants=quads,
                            nowords_ms=cuda_ms(lambda: dyn_tiles(
                                b.rows, b.cols, nowords, blocks, x), 20)),
                        "K4T": dict(
                            bound_ms=blt, bound_by=bylt, bound_tiles_ms=b4t,
                            live_quadrants=quads,
                            nowords_ms=cuda_ms(lambda: dyn_tiles_t(
                                nowords, blocks, gr), 20))}
                # K5's output is every dense tile: 2·F FLOPs per entry,
                # which the kernel computes as three TF32 passes on the
                # tensor cores (hi/lo split); the same FLOPs on the f32
                # CUDA cores are kept beside it
                b5_bytes = (tile_bytes + idx_bytes
                            + (uniq_rows + uniq_cols) * edge * feat * 4)
                b5_flops = 2.0 * k_all * edge * edge * feat
                b5, by5 = bound(b5_bytes, 3 * b5_flops,
                                PEAK_TF32_FLOP_PER_S)
                b5_cc, _ = bound(b5_bytes, b5_flops)
                live5 = {}
                if words:
                    # on the live list: the dense output once (zeros
                    # included), the indices and the list, the distinct
                    # 128-row g and x slabs the live quadrants reach; the
                    # three TF32 passes over the live quadrants alone
                    bl5, byl5 = bound(
                        tile_bytes + idx_bytes + quads * 4
                        + (qt_slabs + q_slabs) * 128 * feat * 4,
                        3 * 2.0 * quads * 128 * 128 * feat,
                        PEAK_TF32_FLOP_PER_S)
                    live5 = dict(
                        bound_ms=bl5, bound_by=byl5, bound_tiles_ms=b5,
                        live_quadrants=quads,
                        nowords_ms=cuda_ms(lambda: dyn_grad_blocks(
                            b.rows, b.cols, gr, x, edge), 10))
                gs = gr.reshape(nb, edge, feat).index_select(0,
                                                             b.rows.long())
                xs = x.reshape(nb, edge, feat).index_select(0, b.cols.long())
                out[f"K4{tag}"].append({**dict(
                    F=feat, **err4, bound_ms=b4, bound_by=by4,
                    ms=cuda_ms(lambda: dyn_tiles(b.rows, b.cols, plan,
                                                 blocks, x), 20),
                    plain_ms=cuda_ms(lambda: dyn_tiles_plain(
                        b.rows, b.cols, plan, blocks, x), 5),
                    library_ms=cuda_ms(lambda: torch.sparse.mm(a_csr, x),
                                       20)), **live4.get("K4", {})})
                # the GAT step at hidden 512 takes no dx in layer 0 (the
                # raw features need no gradient): K4ᵀ runs at F=512 alone
                out[f"K4T{tag}"].append({**dict(
                    F=feat, on_path=feat == HIDDEN, **err4t, bound_ms=b4t,
                    bound_by=by4t,
                    ms=cuda_ms(lambda: dyn_tiles_t(plan, blocks, gr), 20),
                    plain_ms=cuda_ms(lambda: dyn_tiles_t_plain(
                        plan, blocks, gr), 5),
                    library_ms=cuda_ms(lambda: torch.sparse.mm(a_t_csr, gr),
                                       20)), **live4.get("K4T", {})})
                # no one PyTorch call gathers the slabs and multiplies
                # them: the bmm of slabs gathered first stands in
                out[f"K5{tag}"].append({**dict(
                    F=feat, **err5, bound_ms=b5, bound_by=by5,
                    bound_cuda_cores_ms=b5_cc,
                    ms=cuda_ms(lambda: dyn_grad_blocks(b.rows, b.cols, gr, x,
                                                       edge, plan.live), 10),
                    plain_ms=cuda_ms(lambda: dyn_grad_blocks_plain(
                        b.rows, b.cols, gr, x, edge, plan.live), 5),
                    library_ms=cuda_ms(lambda: torch.bmm(
                        gs, xs.transpose(1, 2)), 10),
                    library_label="torch.bmm on pre-gathered slabs (the "
                    "gather excluded), TF32 off"), **live5})
                for k in ("K4", "K4T", "K5"):
                    sh = out[f"{k}{tag}"][-1]
                    print(f"  {k}{tag} F={feat}: kernel_ms={sh['ms']:.4f} "
                          + (f"nowords_ms={sh['nowords_ms']:.4f} "
                             if "nowords_ms" in sh else "")
                          + f"plain_ms={sh['plain_ms']:.4f} library_ms="
                          f"{sh['library_ms']:.4f} bound_ms="
                          f"{sh['bound_ms']:.4f} ({sh['bound_by']})"
                          + (f" bound_tiles_ms={sh['bound_tiles_ms']:.4f}"
                             if "bound_tiles_ms" in sh else ""))
                print(f"  K5{tag} F={feat}: bound on the f32 CUDA cores "
                      f"{b5_cc:.4f} ms")
                del x, gr, gs, xs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def phase_gat_kernels(device, ds, g_gcn) -> tuple:
    """K4, K4ᵀ, K5 and K3w on the bench graph's att_unit operator."""
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.ops.coo_segmm import (segmm_weighted_raw,
                                                segmm_weighted_raw_plain)

    t0 = time.perf_counter()
    g, _ = build_optimized_graph(ds.x, ds.senders, ds.receivers,
                                 y=ds.y, train_mask=ds.train_mask,
                                 layer_name="GATConv", seed=0)
    print(f"GAT ingest (Leiden + hybrid build): "
          f"{time.perf_counter() - t0:.1f} s")
    h, hg = g.aux, g_gcn.aux
    check(h.semantics == "att_unit" and h.dyn_plan is not None,
          "GAT operator without a dynamic-tile plan")
    same = (torch.equal(h.bsr.rows, hg.bsr.rows)
            and torch.equal(h.bsr.cols, hg.bsr.cols)
            and torch.equal(h.bsr.blocks > 0, hg.bsr.blocks != 0)
            and torch.equal(h.senders, hg.senders)
            and torch.equal(h.receivers, hg.receivers))
    check(same, "att_unit tile split differs from the GCN operator's")
    print(f"att_unit operator: {h.bsr.nnz_blocks} tiles and "
          f"{int((h.weights > 0).sum())} stragglers, the same split as the "
          "GCN operator")

    gd = g.to(device)
    hd = gd.aux
    m = hd.segmm
    n = g.num_nodes_padded
    gen = torch.Generator(device=device).manual_seed(1)
    shapes = dyn_kernel_rows(device, hd, gen)
    e = m.senders.shape[0]
    w_edge = torch.rand(e, generator=gen, device=device)
    str_csr = torch.sparse_csr_tensor(m.row_ptr, m.senders,
                                      w_edge * m.weights, (n, n))
    uniq_senders = int(torch.unique(m.senders[m.weights != 0]).numel())

    shapes["K3w"] = []
    with torch.inference_mode():
        for feat in (NUM_CLASSES, 64):
            x = torch.randn((n, feat), generator=gen, device=device)
            print(f"F={feat}:")
            k3w = segmm_weighted_raw(m, w_edge, x)
            k3w_again = segmm_weighted_raw(m, w_edge, x)
            p3w = segmm_weighted_raw_plain(m, w_edge, x)
            torch.cuda.synchronize()
            err3w = compare(f"K3w segmm_weighted_raw F={feat}", k3w, p3w)
            check(torch.equal(k3w, k3w_again), f"K3w F={feat}: two "
                  "launches differ")
            compare(f"K3w library torch.sparse.mm F={feat}",
                    torch.sparse.mm(str_csr, x), p3w)
            b3w, by3w = bound((n + 1) * 4 + e * 12 + uniq_senders * feat * 4
                              + n * feat * 4, 2.0 * e * feat)
            # the GAT step at hidden 64 aggregates at F=64 in both layers
            # (128 → 64, 64 → 64; the head is a separate linear layer):
            # F=40, the class count, is off the path (phase 6 checks it)
            shapes["K3w"].append(dict(
                F=feat, on_path=feat == 64, **err3w, bound_ms=b3w,
                bound_by=by3w,
                **segmm_times(lambda: segmm_weighted_raw(m, w_edge, x)),
                plain_ms=cuda_ms(lambda: segmm_weighted_raw_plain(
                    m, w_edge, x), 20),
                library_ms=cuda_ms(lambda: torch.sparse.mm(str_csr, x), 20)))
            sh = shapes["K3w"][-1]
            print(f"  K3w F={feat}: kernel_ms={sh['ms']:.4f} "
                  f"plain_ms={sh['plain_ms']:.4f} "
                  f"library_ms={sh['library_ms']:.4f} "
                  f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']})"
                  + segmm_note(sh))
    return g, shapes


def phase_fused_kernels(device, g) -> dict:
    """K6 and K7 on the bench graph's att_unit operator at F=128 and 512,
    each against its plain version and beside the two-stage path it
    replaces; K3w on the transpose CSR at F=512 (K6's dx)."""
    from fitgnn_tpu_torch.ops import att_bsr
    from fitgnn_tpu_torch.ops.coo_segmm import (
        segmm_weighted_den_raw, segmm_weighted_den_raw_plain,
        segmm_weighted_raw, segmm_weighted_raw_plain)
    from fitgnn_tpu_torch.ops.tile_gat import tiles_two_stage

    gd = g.to(device)
    hd = gd.aux
    b, plan, m, mt = hd.bsr, hd.dyn_plan, hd.segmm, hd.t_segmm
    rows, cols, blocks = b.rows, b.cols, b.blocks
    n = g.num_nodes_padded
    nb = n // 128
    k_all = b.nnz_blocks
    nnz = int((blocks != 0).sum())
    uniq_cols = int(torch.unique(cols).numel())
    uniq_rows = int(torch.unique(rows).numel())
    gen = torch.Generator(device=device).manual_seed(2)
    # unit-variance scores, as a GAT layer's projections give them, and the
    # fused default branch's stabilizer (the global bound)
    ssrc = torch.randn(n, generator=gen, device=device)
    sdst = torch.randn(n, generator=gen, device=device)
    dden = torch.randn(n, generator=gen, device=device)
    mg = (sdst + ssrc.max()).clamp_min(0.0)
    vec = n * 4
    tile_bytes = k_all * 128 * 128 * 4
    idx_f = (k_all + nb + 1) * 4                  # cols, row_splits
    idx_t = (3 * plan.t_sel.numel() + nb + 1) * 4  # t_sel/scale/cols, splits
    e = m.senders.shape[0]
    w_edge = torch.rand(e, generator=gen, device=device)
    str_csr = torch.sparse_csr_tensor(m.row_ptr, m.senders,
                                      w_edge * m.weights, (n, n))
    uniq_senders = int(torch.unique(m.senders[m.weights != 0]).numel())
    t_perm = hd.t_edge_perm
    wt = w_edge[t_perm.long()].contiguous()
    t_uniq = int(torch.unique(mt.senders[mt.weights != 0]).numel())
    shapes = {k: [] for k in ("K6", "K7rm", "K7f", "K7bt", "K7s", "K7sums",
                              "K3w")}
    fwd = (rows, cols, plan, blocks, ssrc, sdst)
    two_label = ("the two-stage autograd backward for dssrc, dsdst and dx "
                 "(K5, K4ᵀ, the elementwise chain): compare with K7bt + K7s "
                 "+ K7sums")
    two_scores_label = ("the two-stage autograd backward for dssrc and "
                        "dsdst (K5, the elementwise chain): compare with "
                        "K7s + K7sums")
    # the score pass walks one CTA per block row: its longest run of tiles
    runs = plan.row_splits[1:] - plan.row_splits[:-1]
    print(f"score pass: {nb} block rows, {k_all} tiles, the longest block "
          f"row {int(runs.max())} tiles, {int((runs == 0).sum())} without "
          "one")
    # ⟨g, x⟩ at the mask's entries through one PyTorch call (a reference
    # for that part of the pass alone; no one call gives d_raw's sums)
    nz = (blocks != 0).nonzero()
    m_rows = rows.long()[nz[:, 0]] * 128 + nz[:, 1]
    m_cols = cols.long()[nz[:, 0]] * 128 + nz[:, 2]
    mask_csr = torch.sparse_coo_tensor(
        torch.stack([m_rows, m_cols]), torch.ones(nnz, device=device),
        (n, n)).coalesce().to_sparse_csr()
    del nz

    def plain_dx(gr):
        """The dx half of att_bwd_t_plain (materialised pe, bmm, index_add_):
        the plain version of K7bt's walk alone."""
        pe = att_bsr._tile_pe(blocks.index_select(0, plan.t_sel.long()), ssrc,
                              sdst, mg, plan.t_cols, plan.t_rows, SLOPE)[2]
        sc = plan.t_scale.to(pe.dtype)[:, None, None]
        dx = torch.bmm(pe.transpose(1, 2),
                       att_bsr._slabs(gr, plan.t_cols, 128))
        return att_bsr._sum_by_block(sc * dx, plan.t_rows, nb)

    def show(k, last=1):
        for sh in shapes[k][-last:]:
            lib, two = sh["library_ms"], sh.get("two_stage_ms")
            part = f" ({sh['launch']})" if "launch" in sh else ""
            print(f"  {k}{part} F={sh['F']}: kernel_ms={sh['ms']:.4f} "
                  f"plain_ms={sh['plain_ms']:.4f} library_ms="
                  f"{'null' if lib is None else f'{lib:.4f}'} "
                  f"two_stage_ms={'null' if two is None else f'{two:.4f}'} "
                  f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']})")

    with torch.inference_mode():
        # K7rm: F-independent, one launch per layer
        rm = att_bsr.att_rowmax(*fwd, SLOPE)
        rp = att_bsr.att_rowmax_plain(*fwd, SLOPE)
        torch.cuda.synchronize()
        has = rp > -1e29
        check(torch.equal(rm <= -1e29, ~has), "K7rm: rows without a tile "
              "entry differ from the plain version")
        err = compare("K7rm att_rowmax", rm[has], rp[has])
        brm, byrm = bound(tile_bytes + idx_f + 3 * vec, 3.0 * nnz)
        plain_rm = cuda_ms(lambda: att_bsr.att_rowmax_plain(*fwd, SLOPE), 5)
        shapes["K7rm"].append(dict(
            F=None, **err, bound_ms=brm, bound_by=byrm,
            ms=cuda_ms(lambda: att_bsr.att_rowmax(*fwd, SLOPE), 20),
            plain_ms=plain_rm, library_ms=None, two_stage_ms=plain_rm,
            two_stage_label="the materialised tile row max (its plain "
                            "version)"))
        show("K7rm")
    for feat in (NUM_FEATURES, HIDDEN):
        # at F=128 (layer 0, raw features) the backward needs no dx
        need_dx = feat == HIDDEN
        x = torch.randn((n, feat), generator=gen, device=device)
        gr = torch.randn((n, feat), generator=gen, device=device)
        bwd = (plan, blocks, ssrc, sdst, mg, gr, x, dden, SLOPE)
        print(f"F={feat}:")
        with torch.inference_mode():
            num, den = att_bsr.att_fwd(*fwd, mg, x, SLOPE)
            num_p, den_p = att_bsr.att_fwd_plain(*fwd, mg, x, SLOPE)
            dx = att_bsr.att_bwd_t(*bwd, need_dssrc=False)[0]
            dx_p, dss_p = att_bsr.att_bwd_t_plain(*bwd)
            dss, dsd = att_bsr.att_bwd_scores(rows, cols, *bwd)
            dss2, dsd2 = att_bsr.att_bwd_scores(rows, cols, *bwd)
            dsd_p = att_bsr.att_bwd_f_plain(rows, cols, *bwd)
            # the pass and the sums apart, each against its plain version
            # on the same inputs
            part = att_bsr._launch_scores("att_bwd_scores", device, blocks,
                                          rows, cols, None, ssrc, sdst, mg,
                                          gr, x, dden, SLOPE)
            part_p = att_bsr.att_scores_plain(rows, cols, *bwd)
            sums = att_bsr.att_sums(plan, *part_p)
            sums_p = att_bsr.att_sums_plain(plan, *part_p)
            # the entry points of the JAX package's two kernels
            dss_t = att_bsr.att_bwd_t(*bwd, need_dx=False)[1]
            dsd_f = att_bsr.att_bwd_f(rows, cols, *bwd)
            num6, den6 = segmm_weighted_den_raw(m, w_edge, x)
            num6_2, den6_2 = segmm_weighted_den_raw(m, w_edge, x)
            num6_p, den6_p = segmm_weighted_den_raw_plain(m, w_edge, x)
            torch.cuda.synchronize()
            e_f = [compare(f"K7f att_fwd {what} F={feat}", a, p_)
                   for what, a, p_ in (("num", num, num_p),
                                       ("den", den, den_p))]
            e_t = compare(f"K7bt att_bwd_t dx F={feat}", dx, dx_p)
            e_s = [compare(f"K7s att_bwd_scores {what} F={feat}", a, p_)
                   for what, a, p_ in (("dssrc", dss, dss_p),
                                       ("dsdst", dsd, dsd_p))]
            e_p = [compare(f"K7s pass {what} partials F={feat}", a, p_)
                   for what, a, p_ in zip(("column", "row"), part, part_p)]
            e_c = [compare(f"K7sums att_sums {what} F={feat}", a, p_)
                   for what, a, p_ in zip(("dssrc", "dsdst"), sums, sums_p)]
            compare(f"K7bt att_bwd_t dssrc F={feat}", dss_t, dss_p)
            compare(f"K7bf att_bwd_f dsdst F={feat}", dsd_f, dsd_p)
            check(torch.equal(dss, dss2) and torch.equal(dsd, dsd2),
                  f"K7s/K7sums F={feat}: two launches differ")
            print(f"  K7s/K7sums F={feat}: two launches bit-equal")
            del part_p, dss2, dsd2
            e_6 = [compare(f"K6 segmm_weighted_den_raw {what} F={feat}",
                           a, p_) for what, a, p_ in (("num", num6, num6_p),
                                                      ("den", den6, den6_p))]
            check(torch.equal(num6, num6_2) and torch.equal(den6, den6_2),
                  f"K6 F={feat}: two launches differ")
            del num6_2, den6_2
            compare(f"K6 library torch.sparse.mm (num only) F={feat}",
                    torch.sparse.mm(str_csr, x), num6_p)
        # the two-stage path (materialised pe, K4, row sums; its autograd
        # backward: K5, K4ᵀ and the elementwise chain) must agree
        ss_, sd_ = ssrc.clone().requires_grad_(), sdst.clone().requires_grad_()
        x_ = x.clone().requires_grad_(need_dx)
        num2, den2 = tiles_two_stage(SLOPE, rows, cols, plan, blocks, ss_,
                                     sd_, mg, x_)
        inputs = (ss_, sd_, x_) if need_dx else (ss_, sd_)
        grads2 = torch.autograd.grad((num2, den2), inputs, (gr, dden),
                                     retain_graph=True)
        compare(f"K7f num vs two-stage F={feat}", num, num2.detach())
        compare(f"K7f den vs two-stage F={feat}", den, den2.detach())
        compare(f"K7s dssrc vs two-stage F={feat}", dss, grads2[0])
        compare(f"K7s dsdst vs two-stage F={feat}", dsd, grads2[1])
        if need_dx:
            compare(f"K7bt dx vs two-stage F={feat}", dx, grads2[2])
        two_bwd = cuda_ms(lambda: torch.autograd.grad(
            (num2, den2), inputs, (gr, dden), retain_graph=True), 5)
        two_scores = cuda_ms(lambda: torch.autograd.grad(
            (num2, den2), (ss_, sd_), (gr, dden), retain_graph=True), 5)
        del num2, den2, grads2
        with torch.inference_mode():
            slabs = 128 * feat * 4
            # K7f: tiles once, the three score vectors, the slabs of the
            # distinct input blocks, num and den out; 2·F FLOPs per tile
            # non-zero for the product, 1 for den, ~4 for score, LeakyReLU,
            # subtract and exp
            bf, byf = bound(tile_bytes + idx_f + 3 * vec + uniq_cols * slabs
                            + n * feat * 4 + vec, nnz * (2.0 * feat + 5))
            # K7s, the pass: tiles, four vectors, the distinct g and x
            # slabs, the two (K, 128) partials out; 2·F FLOPs per
            # non-zero for the ⟨g, x⟩ of d_pe and ~8 for the score, its
            # gradient and the sums.  Its dense product (three TF32
            # passes on the tensor cores) is printed beside it.
            bs, bys = bound(tile_bytes + 2 * k_all * 4 + 4 * vec
                            + (uniq_rows + uniq_cols) * slabs
                            + 2 * k_all * 128 * 4, nnz * (2.0 * feat + 8))
            bs_tc = 3 * 2.0 * k_all * 128 * 128 * feat \
                / PEAK_TF32_FLOP_PER_S * 1e3
            # K7sums: the partials read once, both walks' indices, dssrc
            # and dsdst out; one add a partial
            bc, byc = bound(2 * k_all * 128 * 4 + idx_t + (nb + 1) * 4
                            + 2 * vec, 2 * k_all * 128.0)
            # K7bt's dx: tiles, the transpose plan, ssrc, sdst and m, the
            # slabs of the distinct g blocks (the forward row blocks), dx
            # out; 2·F FLOPs per non-zero for peᵀ @ g and ~5 for pe
            bdx, bydx = bound(tile_bytes + idx_t + 3 * vec
                              + uniq_rows * slabs + n * feat * 4,
                              nnz * (2.0 * feat + 5))
            b6, by6 = bound((n + 1) * 4 + e * 12 + uniq_senders * feat * 4
                            + n * feat * 4 + vec, (2.0 * feat + 1) * e)
            shapes["K7f"].append(dict(
                F=feat, max_abs_err=max(er["max_abs_err"] for er in e_f),
                max_rel_err=max(er["max_rel_err"] for er in e_f),
                bound_ms=bf, bound_by=byf,
                ms=cuda_ms(lambda: att_bsr.att_fwd(*fwd, mg, x, SLOPE), 20),
                plain_ms=cuda_ms(lambda: att_bsr.att_fwd_plain(
                    *fwd, mg, x, SLOPE), 5), library_ms=None,
                two_stage_ms=cuda_ms(lambda: tiles_two_stage(
                    SLOPE, rows, cols, plan, blocks, ssrc, sdst, mg, x), 10),
                two_stage_label="materialised pe, K4 and the den row sums"))
            # K7bt's dx walk alone; the main path launches it at F=512
            # only (layer 1), so the F=128 row is off the path
            compare(f"K7bt dx plain half vs att_bwd_t_plain F={feat}",
                    plain_dx(gr), dx_p)
            shapes["K7bt"].append(dict(
                F=feat, launch="dx", on_path=need_dx, **e_t,
                bound_ms=bdx, bound_by=bydx,
                ms=cuda_ms(lambda: att_bsr._launch_walk(
                    "att_bwd_t (dx)", device, blocks, plan.t_row_splits,
                    plan.t_sel, plan.t_scale, plan.t_cols, None, ssrc, sdst,
                    mg, gr, None, True, SLOPE), 20),
                plain_ms=cuda_ms(lambda: plain_dx(gr), 5), library_ms=None,
                two_stage_ms=two_bwd if need_dx else None,
                two_stage_label=two_label))
            # K7s: the pass alone; K7sums: the sums alone; both outputs
            # through att_bwd_scores (the pass and the sums, what replaced
            # the two reductions) beside them
            xt = x.t().contiguous()
            sampled = torch.sparse.sampled_addmm(mask_csr, gr, xt, beta=0.0)
            pick = torch.arange(0, nnz, max(1, nnz // 4096), device=device)
            compare(f"K7s reference sampled_addmm ⟨g, x⟩ F={feat}",
                    sampled.values()[pick],
                    (gr[torch.bucketize(pick, sampled.crow_indices(),
                                        right=True) - 1]
                     * x[sampled.col_indices()[pick]]).sum(1))
            del sampled
            both_ms = cuda_ms(lambda: att_bsr.att_bwd_scores(
                rows, cols, *bwd), 20)
            both_dev = device_ms(lambda: att_bsr.att_bwd_scores(
                rows, cols, *bwd), 20)
            shapes["K7s"].append(dict(
                F=feat, max_abs_err=max(er["max_abs_err"]
                                        for er in (*e_s, *e_p)),
                max_rel_err=max(er["max_rel_err"] for er in (*e_s, *e_p)),
                bound_ms=bs, bound_by=bys, bound_tensor_cores_ms=bs_tc,
                ms=cuda_ms(lambda: att_bsr._launch_scores(
                    "att_bwd_scores", device, blocks, rows, cols, None, ssrc,
                    sdst, mg, gr, x, dden, SLOPE), 20),
                plain_ms=cuda_ms(lambda: att_bsr.att_scores_plain(
                    rows, cols, *bwd), 5),
                library_ms=None,
                sampled_addmm_ms=cuda_ms(lambda: torch.sparse.sampled_addmm(
                    mask_csr, gr, xt, beta=0.0), 20),
                both_outputs_ms=both_ms, both_outputs_device_ms=both_dev,
                both_outputs_plain_ms=cuda_ms(
                    lambda: att_bsr.att_bwd_scores_plain(rows, cols, *bwd),
                    5),
                two_stage_ms=two_scores, two_stage_label=two_scores_label))
            # the sums take a few microseconds, under their wrapper's host
            # work: ms is the device time, wrapper_ms cuda_ms's
            shapes["K7sums"].append(dict(
                F=feat, max_abs_err=max(er["max_abs_err"] for er in e_c),
                max_rel_err=max(er["max_rel_err"] for er in e_c),
                bound_ms=bc, bound_by=byc,
                ms=device_ms(lambda: att_bsr.att_sums(plan, *part), 20),
                wrapper_ms=cuda_ms(lambda: att_bsr.att_sums(plan, *part), 20),
                plain_ms=cuda_ms(lambda: att_bsr.att_sums_plain(
                    plan, *part), 20), library_ms=None,
                two_stage_ms=None, two_stage_label=two_scores_label))
            sh = shapes["K7s"][-1]
            print(f"  K7s+K7sums F={feat}: both outputs "
                  f"{sh['both_outputs_ms']:.4f} ms (device time "
                  f"{sh['both_outputs_device_ms']:.4f}; plain "
                  f"{sh['both_outputs_plain_ms']:.4f}); the pass's dense "
                  f"product at the TF32 rate {bs_tc:.4f} ms; "
                  f"torch.sparse.sampled_addmm (⟨g, x⟩ alone) "
                  f"{sh['sampled_addmm_ms']:.4f} ms")
            del xt, part
            shapes["K6"].append(dict(
                F=feat, max_abs_err=max(er["max_abs_err"] for er in e_6),
                max_rel_err=max(er["max_rel_err"] for er in e_6),
                bound_ms=b6, bound_by=by6,
                **segmm_times(lambda: segmm_weighted_den_raw(m, w_edge, x)),
                plain_ms=cuda_ms(lambda: segmm_weighted_den_raw_plain(
                    m, w_edge, x), 20),
                library_ms=cuda_ms(lambda: torch.sparse.mm(str_csr, x), 20),
                library_label="torch.sparse.mm with runtime weights: num "
                              "only"))
            for k in ("K7f", "K7bt", "K7s", "K7sums", "K6"):
                show(k)
            print("  K6" + segmm_note(shapes["K6"][-1]))
            if feat == HIDDEN:
                # K6's dx in layer 1: K3w on the transpose CSR, the weights
                # w_edge[t_edge_perm] formed inside the kernel
                k3w = segmm_weighted_raw(mt, w_edge, gr, t_perm)
                k3w_again = segmm_weighted_raw(mt, w_edge, gr, t_perm)
                p3w = segmm_weighted_raw_plain(mt, w_edge, gr, t_perm)
                torch.cuda.synchronize()
                err3w = compare(f"K3w transpose CSR F={feat}", k3w, p3w)
                check(torch.equal(k3w, k3w_again), f"K3w transpose F={feat}:"
                      " two launches differ")
                del k3w_again
                t_csr = torch.sparse_csr_tensor(mt.row_ptr, mt.senders,
                                                wt * mt.weights, (n, n))
                # the CSR, senders, static weights, w_edge and perm once
                b3w, by3w = bound((n + 1) * 4 + e * 16 + t_uniq * feat * 4
                                  + n * feat * 4, 2.0 * e * feat)
                shapes["K3w"].append(dict(
                    F=feat, transpose=True, **err3w, bound_ms=b3w,
                    bound_by=by3w,
                    **segmm_times(lambda: segmm_weighted_raw(
                        mt, w_edge, gr, t_perm)),
                    plain_ms=cuda_ms(lambda: segmm_weighted_raw_plain(
                        mt, w_edge, gr, t_perm), 20),
                    library_ms=cuda_ms(lambda: torch.sparse.mm(t_csr, gr),
                                       20)))
                show("K3w")
                print("  K3w" + segmm_note(shapes["K3w"][-1]))
        del x, gr, x_, ss_, sd_
        torch.cuda.empty_cache()
    return shapes


def optin_operators(ds, g) -> dict:
    """The bench graph's GCN operator under each opt-in, on the node order
    of ``g``: ``use_diag`` and ``tile_group=2`` through
    ``build_optimized_graph``, the row walk through ``build_hybrid`` on the
    reordered graph (``build_optimized_graph`` has no ``use_rowwalk``, nor
    has the JAX one; ``bench.py`` builds it so)."""
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

    ops = {}
    t0 = time.perf_counter()
    for name, kw in (("diag", dict(use_diag=True)),
                     ("group2", dict(tile_group=2))):
        g2, _ = build_optimized_graph(ds.x, ds.senders, ds.receivers,
                                      y=ds.y, train_mask=ds.train_mask,
                                      layer_name="GCNConv", seed=0, **kw)
        check(torch.equal(g2.senders, g.senders)
              and torch.equal(g2.receivers, g.receivers),
              f"{name}: node order differs from the default operator's")
        ops[name] = g2.aux
    ops["rowwalk"] = build_hybrid(
        g.senders.numpy(), g.receivers.numpy(), g.edge_weight.numpy(),
        g.num_nodes_padded, min_block_edges=48, use_segmm=True,
        use_rowwalk=True)
    print(f"opt-in ingest: {time.perf_counter() - t0:.1f} s")
    hd, b0 = ops["diag"], g.aux.bsr
    diag_nz = int((hd.diag_blocks != 0).flatten(1).any(1).sum())
    print(f"use_diag: {hd.diag_blocks.shape[0]} diagonal blocks "
          f"({diag_nz} non-zero), diag_r={hd.diag_r}, "
          f"{0 if hd.bsr is None else hd.bsr.nnz_blocks} off-diagonal "
          f"tiles with fillers")
    check(hd.diag_r > 0 and hd.bsr is not None,
          "use_diag: expected the K8 chain with off-diagonal tiles")
    bg, br = ops["group2"].bsr, ops["rowwalk"].bsr
    splits = br.row_splits
    print(f"tile_group=2: {bg.nnz_blocks} tiles (grid walk: "
          f"{b0.nnz_blocks}); rowwalk: {br.nnz_blocks} tiles, "
          f"{int((splits[1:] == splits[:-1]).sum())} block rows without one")
    for name in ("group2", "rowwalk"):
        check(torch.equal(ops[name].senders, g.aux.senders),
              f"{name}: straggler split differs from the default operator's")
    return ops


def phase_optin_kernels(device, g, ops) -> dict:
    """K2, K9 and K10 at F=128 and 512 on their layouts, K8 forward and
    transpose with and without init at F=128 and 512, and K11 at (N_pad,
    512) bit for bit, each against its plain version."""
    from fitgnn_tpu_torch.ops.bsr_spmm import (bsr_spmm_fwd,
                                               bsr_spmm_grouped,
                                               bsr_spmm_plain,
                                               bsr_spmm_rowwalk)
    from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm, diag_spmm_plain
    from fitgnn_tpu_torch.ops.dropout import (philox_dropout,
                                              philox_dropout_plain,
                                              seed_from_generator)

    n = g.num_nodes_padded
    b0 = g.aux.bsr.to(device)
    walks = {"K2": (b0, bsr_spmm_fwd),
             "K9": (ops["group2"].bsr.to(device), bsr_spmm_grouped),
             "K10": (ops["rowwalk"].bsr.to(device), bsr_spmm_rowwalk)}
    diag, r8 = ops["diag"].diag_blocks.to(device), ops["diag"].diag_r
    # the three walks compute one function: the grid walk's tile non-zeros
    a_tiles, nnz = tile_csr(b0, n)
    nz_tile = (b0.blocks != 0).flatten(1).any(1)
    tiles = int(nz_tile.sum())
    uniq_cols = int(torch.unique(b0.cols[nz_tile]).numel())
    nb = n // 128
    diag_live = (diag != 0).flatten(1).any(1)
    diag_nnz = int((diag != 0).sum())
    row_nnz = (diag != 0).sum(2).flatten().float()
    print(f"K8 diagonal blocks: {diag.shape[0]} ({int(diag_live.sum())} with "
          f"a non-zero), {diag_nnz} non-zeros, fill "
          f"{diag_nnz / diag.numel():.4f}, {float(row_nnz.mean()):.2f} a row "
          f"on average, {int(row_nnz.max())} at most")
    gen = torch.Generator(device=device).manual_seed(4)
    shapes = {k: [] for k in ("K2", "K9", "K10", "K8", "K11")}

    def show(k):
        sh = shapes[k][-1]
        lib = sh["library_ms"]
        print(f"  {k} {sh['shape']}: kernel_ms={sh['ms']:.4f} "
              f"plain_ms={sh['plain_ms']:.4f} library_ms="
              f"{'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']})")

    with torch.inference_mode():
        for feat in (NUM_FEATURES, HIDDEN):
            x = torch.randn((n, feat), generator=gen, device=device)
            init = torch.randn((n, feat), generator=gen, device=device)
            print(f"F={feat}:")
            ref = bsr_spmm_plain(b0, x)
            lib = torch.sparse.mm(a_tiles, x)
            compare(f"tile walks library torch.sparse.mm F={feat}", lib, ref)
            # the walks' function: every tile with a non-zero read once,
            # the slabs of the distinct input blocks, the output written;
            # 2 FLOPs per tile non-zero and feature
            bw, byw = bound(tiles * 128 * 128 * 4 + (tiles + nb + 1) * 4
                            + uniq_cols * 128 * feat * 4 + n * feat * 4,
                            2.0 * nnz * feat)
            lib_ms = cuda_ms(lambda: torch.sparse.mm(a_tiles, x), 20)
            for k, (b, walk) in walks.items():
                got = walk(b, x)
                torch.cuda.synchronize()
                err = compare(f"{k} {walk.__name__} F={feat}", got,
                              bsr_spmm_plain(b, x))
                compare(f"{k} vs the grid walk's plain version F={feat}",
                        got, ref)
                shapes[k].append(dict(
                    F=feat, shape=f"F={feat}", **err, bound_ms=bw,
                    bound_by=byw, ms=cuda_ms(lambda: walk(b, x), 20),
                    plain_ms=cuda_ms(lambda: bsr_spmm_plain(b, x), 5),
                    library_ms=lib_ms))
                show(k)
            del got, ref, lib
            # K8: blocks, x, init once, out once; 2 FLOPs per block
            # non-zero and feature.  On the path: F=128 forward (layer 0),
            # F=512 forward and transpose (layer 1), each with init.
            x3, i3 = x.reshape(nb, 128, feat), init.reshape(nb, 128, feat)
            for transpose in (False, True):
                a3 = diag.transpose(1, 2) if transpose else diag
                for with_init in (True, False):
                    it = init if with_init else None
                    got = diag_spmm(diag, x, r8, transpose, it)
                    torch.cuda.synchronize()
                    tag = (f"F={feat}{' transpose' if transpose else ''}"
                           f"{' init' if with_init else ''}")
                    err = compare(f"K8 diag_spmm {tag}", got,
                                  diag_spmm_plain(diag, x, r8, transpose, it))

                    def lib8(a3=a3, with_init=with_init):
                        if with_init:
                            return torch.baddbmm(i3, a3, x3)
                        return torch.bmm(a3, x3)

                    compare(f"K8 library torch.baddbmm {tag}",
                            lib8().reshape(n, feat),
                            diag_spmm_plain(diag, x, r8, transpose, it))
                    b8, by8 = bound(int(diag_live.sum()) * 128 * 128 * 4
                                    + n * feat * 4 * (3 if with_init else 2),
                                    2.0 * diag_nnz * feat)
                    shapes["K8"].append(dict(
                        F=feat, shape=tag, transpose=transpose,
                        init=with_init,
                        on_path=with_init and (feat == HIDDEN
                                               or not transpose),
                        **err, bound_ms=b8, bound_by=by8,
                        ms=cuda_ms(lambda: diag_spmm(diag, x, r8, transpose,
                                                     it), 20),
                        plain_ms=cuda_ms(lambda: diag_spmm_plain(
                            diag, x, r8, transpose, it), 5),
                        library_ms=cuda_ms(lib8, 20)))
                    show("K8")
            del x, init, x3, i3, got
        # K11 at the layer output's shape, bit for bit
        x = torch.randn((n, HIDDEN), generator=gen, device=device)
        seed = seed_from_generator(gen, device)
        got = philox_dropout(x, seed, 0.5)
        ref = philox_dropout_plain(x, seed, 0.5)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), "K11: kernel and plain version differ")
        kept = float((got != 0).float().mean())
        print(f"K11 philox_dropout: bit-exact, kept {kept:.5f} of "
              f"{x.numel()} at rate 0.5")
        check(abs(kept - 0.5) < 4 * (0.25 / x.numel()) ** 0.5,
              "K11: keep rate outside 4 sigma")
        # x read once, out written once, one f32 multiply an element (the
        # Philox integer rounds, ~25 operations an element, have no rate in
        # the f32 table and would bind below the bytes anyway)
        b11, by11 = bound(2 * x.numel() * 4 + 4, float(x.numel()))
        shapes["K11"].append(dict(
            F=HIDDEN, shape=f"({n}, {HIDDEN})", max_abs_err=0.0,
            max_rel_err=0.0, bit_exact=True, bound_ms=b11, bound_by=by11,
            ms=cuda_ms(lambda: philox_dropout(x, seed, 0.5), 20),
            plain_ms=cuda_ms(lambda: philox_dropout_plain(x, seed, 0.5), 3),
            library_ms=cuda_ms(lambda: torch.nn.functional.dropout(
                x, 0.5, training=True), 20),
            library_label="torch.nn.functional.dropout (its own mask "
                          "stream)"))
        show("K11")
        del x, got, ref
    torch.cuda.empty_cache()
    return shapes


# launches of one training step and one eval forward of a 2-layer model at
# hidden 512, read from the autograd graph and confirmed by phase 4:
# GAT layer 0 aggregates the raw 128-wide features (no dx, so no K4ᵀ),
# layer 1 the 512-wide transformed ones; GCN layer 0 aggregates the raw
# features (no backward), layer 1 its transformed input
STEP = {"GATConv": {"K4": 2, "K4T": 1, "K5": 2},
        "GCNConv": {"K1": 3, "K3": 3},
        # SAGE and GIN aggregate as GCN does: layer 0 the raw features
        # (forward only), layer 1 its 512-wide input; pre-aggregated,
        # layer 0 aggregates nothing (its K3 and K1 run once, at ingest)
        "SAGEConv": {"K1": 3, "K3": 3}, "GINConv": {"K1": 3, "K3": 3},
        "SAGEConv preaggregated": {"K1": 2, "K3": 2},
        "GINConv preaggregated": {"K1": 2, "K3": 2},
        # FUSED: the score pass and its column sum in both layers, K7bt's
        # dx walk and K6's dx (a K3w launch) in layer 1 only
        "GATConv fused": {"K7f": 2, "K7bt": 1, "K7s": 2, "K7sums": 2,
                          "K6": 2, "K3w": 1},
        "GATConv fused exact": {"K7rm": 2, "K7f": 2, "K7bt": 1, "K7s": 2,
                                "K7sums": 2}}
EVAL = {"GATConv": {"K4": 2}, "GCNConv": {"K1": 2, "K3": 2},
        "SAGEConv": {"K1": 2, "K3": 2}, "GINConv": {"K1": 2, "K3": 2},
        "SAGEConv preaggregated": {"K1": 1, "K3": 1},
        "GINConv preaggregated": {"K1": 1, "K3": 1},
        "GATConv fused": {"K7f": 2, "K6": 2},
        "GATConv fused exact": {"K7rm": 2, "K7f": 2},
        "GATConv fused tiles": {"K7f": 2}}
# the switches of each mode
MODE_ENV = {"GATConv": {}, "GCNConv": {}, "SAGEConv": {}, "GINConv": {},
            "SAGEConv preaggregated": {}, "GINConv preaggregated": {},
            "GATConv fused": FUSED,
            "GATConv fused exact": FUSED_EXACT,
            "GATConv fused tiles": FUSED_ONLY}


@contextlib.contextmanager
def plain_versions():
    """Every kernel's plain version where the path calls the wrapper."""
    from fitgnn_tpu_torch.ops import att_bsr, bsr_dynamic, coo_segmm
    from fitgnn_tpu_torch.ops import hybrid_spmm as hybrid_mod
    from fitgnn_tpu_torch.ops import tile_gat
    from fitgnn_tpu_torch.ops.bsr_spmm import bsr_spmm_acc_plain
    from fitgnn_tpu_torch.ops.coo_segmm import segmm_spmm_plain
    from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm_plain

    with contextlib.ExitStack() as stack:
        for module, name, plain in (
                (hybrid_mod, "bsr_spmm_acc", bsr_spmm_acc_plain),
                (hybrid_mod, "segmm_spmm", segmm_spmm_plain),
                (hybrid_mod, "diag_spmm", diag_spmm_plain),
                (bsr_dynamic, "dyn_tiles", bsr_dynamic.dyn_tiles_plain),
                (bsr_dynamic, "dyn_tiles_t", bsr_dynamic.dyn_tiles_t_plain),
                (bsr_dynamic, "dyn_grad_blocks",
                 bsr_dynamic.dyn_grad_blocks_plain),
                (coo_segmm, "segmm_weighted_raw",
                 coo_segmm.segmm_weighted_raw_plain),
                (coo_segmm, "segmm_weighted_den_raw",
                 coo_segmm.segmm_weighted_den_raw_plain),
                (tile_gat, "att_rowmax", att_bsr.att_rowmax_plain),
                (att_bsr, "att_fwd", att_bsr.att_fwd_plain),
                (att_bsr, "att_bwd_t", att_bsr.att_bwd_t_plain),
                (att_bsr, "att_bwd_scores", att_bsr.att_bwd_scores_plain)):
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def phase_gradients(device, g_gat, g_gcn) -> None:
    """One training step with the kernels, then with the plain versions
    patched in: the loss and every gradient, and the step's launches."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.train.losses import masked_nll

    default_gat = None
    for mode, g in (("GATConv", g_gat), ("GCNConv", g_gcn),
                    ("GATConv fused", g_gat)):
        layer = mode.split()[0]
        gd = g.to(device)
        model = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                          dropout_rate=0.0)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to(device).train()

        def step():
            model.zero_grad(set_to_none=True)
            loss = masked_nll(model(gd.x, gd), gd.y, gd.train_mask)
            loss.backward()
            torch.cuda.synchronize()
            return loss.detach(), {k: p.grad.detach().clone()
                                   for k, p in model.named_parameters()}

        with switches(MODE_ENV[mode]):
            reset_counts()
            loss_k, grads_k = step()
            expect(read_counts(), STEP[mode], f"{mode} train step")
            reset_counts()
            with plain_versions():
                loss_p, grads_p = step()
        expect(read_counts(), {}, f"{mode} train step, plain versions")
        compare(f"{mode} loss kernels vs plain", loss_k.reshape(1),
                loss_p.reshape(1))
        for k in grads_p:
            compare(f"{mode} grad {k}", grads_k[k], grads_p[k])
        if mode == "GATConv":
            default_gat = (loss_k, grads_k)
        elif layer == "GATConv":
            # the same step through the two-stage path (the default)
            compare(f"{mode} loss vs the default step",
                    loss_k.reshape(1), default_gat[0].reshape(1))
            for k in grads_k:
                compare(f"{mode} grad {k} vs the default step", grads_k[k],
                        default_gat[1][k])
        del model, gd, grads_k, grads_p
        torch.cuda.empty_cache()


# launches of one GCN training step and one eval forward on each opt-in
# operator (hidden 512, dropout 0.5 through K11): layer 0 aggregates the
# raw features (forward only), layer 1 forward and backward; K11 after each
# layer, forward and backward
OPTIN_STEP = {"diag": {"K3": 3, "K8": 3, "K1": 3, "K11": 4},
              "group2": {"K3": 3, "K9": 3, "K11": 4},
              "rowwalk": {"K3": 3, "K10": 3, "K11": 4}}
OPTIN_EVAL = {"diag": {"K3": 2, "K8": 2, "K1": 2},
              "group2": {"K3": 2, "K9": 2}, "rowwalk": {"K3": 2, "K10": 2}}
OPTIN_EPOCHS = 2


def phase_optin_train(device, g, ops) -> dict:
    """GCNConv at hidden 512 with ``fused_dropout=True, bit_dropout=False``
    (dropout 0.5, so K11 runs) on each opt-in operator: one step's loss and
    gradients against the default operator's under the same seed (the same
    K11 masks), then ``OPTIN_EPOCHS`` epochs (a ``gc_train_step`` and a
    ``gc_eval_step`` each) with every counter at 0 just before, and an eval
    forward against the default operator's."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.train import steps
    from fitgnn_tpu_torch.train.losses import masked_nll

    def model_():
        m = NodeModel("GCNConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                      dropout_rate=0.5, fused_dropout=True,
                      bit_dropout=False)
        return m.reset_parameters(torch.Generator().manual_seed(0)).to(
            device)

    def one_step(gd):
        model = model_().train()
        gen = torch.Generator(device=device).manual_seed(0)
        loss = masked_nll(model(gd.x, gd, gen), gd.y, gd.train_mask)
        loss.backward()
        model.eval()
        with torch.inference_mode():
            out = model(gd.x, gd)
        torch.cuda.synchronize()
        return loss.detach(), {k: p.grad.detach().clone()
                               for k, p in model.named_parameters()}, out

    gd0 = g.to(device)
    loss0, grads0, out0 = one_step(gd0)
    del gd0
    phases = {}
    for name, h in ops.items():
        gd = g._replace(aux=h).to(device)
        loss, grads, out = one_step(gd)
        compare(f"{name} step loss vs the default operator",
                loss.reshape(1), loss0.reshape(1))
        for k in grads0:
            compare(f"{name} grad {k} vs the default operator", grads[k],
                    grads0[k])
        compare(f"{name} eval forward vs the default operator", out, out0)
        model = model_()
        opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
        gen = torch.Generator(device=device).manual_seed(0)
        evals = ~gd.train_mask
        losses = []
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(OPTIN_EPOCHS):
            losses.append(steps.gc_train_step(model, opt, gd, gd.y,
                                              gd.train_mask, gen,
                                              "classification"))
            losses.append(steps.gc_eval_step(model, gd, gd.y, evals,
                                             "classification")[0])
        torch.cuda.synchronize()
        launches, wall = read_counts(), time.perf_counter() - t0
        losses = [float(v) for v in losses]
        check(all(np.isfinite(v) and v > 0 for v in losses),
              f"{name}: bad losses {losses}")
        print(f"train gcn512 {name}: {OPTIN_EPOCHS} epochs in {wall:.2f} s, "
              f"losses {[round(v, 4) for v in losses]}")
        want = {k: OPTIN_EPOCHS * (OPTIN_STEP[name].get(k, 0)
                                   + OPTIN_EVAL[name].get(k, 0))
                for k in (*OPTIN_STEP[name], *OPTIN_EVAL[name])}
        expect(launches, want, f"train gcn512 {name}")
        phases[f"train gcn512 {name}"] = launches
        del gd, model, opt, grads
        torch.cuda.empty_cache()
    return phases


def phase_forward_only(device, g) -> dict:
    """K2 on its paths: eval forwards of the GCN model on a forward-only
    operator (the BCSR without its transpose: K3 then K2 per layer), held
    against the default operator's forward, and ``spmm(operator=
    BsrMatrix)`` forward and backward at F=512."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.ops.bsr_spmm import bsr_spmm_plain
    from fitgnn_tpu_torch.ops.spmm import spmm

    h = g.aux
    fwd_only = dataclasses.replace(h, bsr=dataclasses.replace(
        h.bsr, transpose=None))
    gd, gf = g.to(device), g._replace(aux=fwd_only).to(device)
    model = NodeModel("GCNConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES)
    model = model.reset_parameters(torch.Generator().manual_seed(0)).to(
        device).eval()
    forwards = 4
    with torch.inference_mode():
        ref = model(gd.x, gd)
        reset_counts()
        outs = [model(gf.x, gf) for _ in range(forwards)]
        torch.cuda.synchronize()
        serve = read_counts()
    expect(serve, {"K3": 2 * forwards, "K2": 2 * forwards},
           "serve gcn512 forward-only")
    for out in outs[:1]:
        compare("forward-only operator vs the default operator", out, ref)
    b = gd.aux.bsr
    gen = torch.Generator(device=device).manual_seed(6)
    x = torch.randn((g.num_nodes_padded, HIDDEN), generator=gen,
                    device=device, requires_grad=True)
    gr = torch.randn((g.num_nodes_padded, HIDDEN), generator=gen,
                     device=device)
    reset_counts()
    out = spmm(None, None, None, x, g.num_nodes_padded, operator=b)
    out.backward(gr)
    torch.cuda.synchronize()
    lib = read_counts()
    expect(lib, {"K2": 2}, "spmm(operator=BsrMatrix) forward and backward")
    with torch.inference_mode():
        compare("spmm(operator=BsrMatrix) vs plain", out.detach(),
                bsr_spmm_plain(b, x.detach()))
        compare("spmm(operator=BsrMatrix) dx vs plain", x.grad,
                bsr_spmm_plain(b.transpose, gr))
    del gd, gf, x, gr, out
    torch.cuda.empty_cache()
    return {"serve gcn512 forward-only": serve,
            "spmm BsrMatrix fwd+bwd F=512": lib}


def run_cli(tmp, argv, env=None, dataset="bench") -> tuple:
    """Run the port's CLI on ``dataset`` from ``tmp`` under the switches
    ``env`` with every counter at 0 just before; returns (launches,
    NodeModel forwards, seconds)."""
    from fitgnn_tpu_torch.cli.main import main as cli_main
    from fitgnn_tpu_torch.models.models import NodeModel

    forwards = [0]

    def count_forward(module, args, output):
        if isinstance(module, NodeModel):
            forwards[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(
        count_forward)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with switches(env or {}):
            reset_counts()
            t0 = time.perf_counter()
            rc = cli_main([*argv, "--dataset", dataset, "--data_root",
                           os.path.join(tmp, "dataset"), "--experiment",
                           "random", "--device", "cuda"])
            torch.cuda.synchronize()
            launches, wall = read_counts(), time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        hook.remove()
    check(rc == 0, f"{argv[0]} returned {rc}")
    return launches, forwards[0], wall


def expect(launches: dict, want: dict, what: str) -> None:
    got = {k: v for k, v in launches.items() if v}
    want = {k: v for k, v in want.items() if v}
    print(f"{what}: launches {got}")
    check(got == want, f"{what}: launches {got}, expected {want}")


def phase_train(tmp) -> dict:
    """``train --baseline`` through the CLI: GAT 512 (3 epochs), GCN 512 (2
    epochs), GAT 64 (1 epoch, K3w), GAT 512 under ``FUSED`` (2 epochs) and
    ``FUSED_EXACT`` (1 epoch).  Per epoch one train step and one val
    forward; per run a warm-up and a timed test forward."""
    from fitgnn_tpu_torch.utils.results import TRAIN_NODE_CLS_HEADER

    phases = {}
    runs = (("gat512", "GATConv", HIDDEN, 3),
            ("gcn512", "GCNConv", HIDDEN, 2),
            ("gat64", "GATConv", 64, 1),
            ("gat512fused", "GATConv fused", HIDDEN, 2),
            ("gat512exact", "GATConv fused exact", HIDDEN, 1))
    from fitgnn_tpu_torch.ops import coo_segmm

    launch, widths = coo_segmm._launch, {}

    def k3w_widths(what, m, x, *args, **kwargs):
        """The straggler sum's launch as it is, tallying K3w's widths."""
        if what == "segmm_weighted_raw":
            widths[x.shape[1]] = widths.get(x.shape[1], 0) + 1
        return launch(what, m, x, *args, **kwargs)

    for out_dir, mode, hidden, epochs in runs:
        with mock.patch.object(coo_segmm, "_launch", k3w_widths):
            launches, _, wall = run_cli(tmp, [
                "train", "--baseline", "--layer_name", mode.split()[0],
                "--hidden", str(hidden), "--runs", "1", "--epochs1",
                str(epochs), "--output_dir", out_dir], MODE_ENV[mode])
        print(f"train {out_dir}: {wall:.1f} s")
        if hidden == 64:
            # K3w's F=40 row of phase 3 (the class count) is off the path
            print(f"train {out_dir}: K3w widths {widths}")
            check(set(widths) == {64}, f"K3w at hidden 64 ran at widths "
                  f"{widths}, expected 64 alone")
        widths.clear()
        if hidden == HIDDEN:
            want = {k: epochs * (STEP[mode].get(k, 0)
                                 + EVAL[mode].get(k, 0))
                    + 2 * EVAL[mode].get(k, 0)
                    for k in (*STEP[mode], *EVAL[mode])}
        else:
            # at hidden 64 layer 0 is 128 → 64, so both layers aggregate
            # transformed (64-wide) features: K4ᵀ twice per step, and the
            # stragglers take K3w, forward and dx, in every layer
            want = {"K4": epochs * 4 + 4, "K4T": epochs * 2,
                    "K5": epochs * 2, "K3w": epochs * (4 + 2) + 4}
        expect(launches, want, f"train {out_dir}")
        ckpt = os.path.join(tmp, "save", "node_cls", "baseline", out_dir,
                            "model.pt")
        check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
        phases[f"train {out_dir}"] = launches
    with open(os.path.join(tmp, "results", "baseline", "bench.csv")) as f:
        lines = f.read().splitlines()
    check(lines[0] == TRAIN_NODE_CLS_HEADER and len(lines) == 1 + len(runs),
          f"train CSV not written under the header: {lines[:2]}")
    for line in lines[1:]:
        row = dict(zip(lines[0].split(","), line.split(",")))
        loss = float(row["best_loss"])
        check(np.isfinite(loss) and loss > 0, f"bad loss in row {line}")
        print(f"train row: layer={row['layer_name']} hidden={row['hidden']} "
              f"best_acc={row['best_acc']} best_loss={row['best_loss']} "
              f"ave_time={row['ave_time']}")
    return phases


def phase_gat_serve(tmp) -> dict:
    """``infer-baseline`` for GAT 512 from the default run's checkpoint, then
    under ``FUSED_TILES=1`` from the fused run's."""
    phases = {}
    for out_dir, mode in (("gat512", "GATConv"),
                          ("gat512fused", "GATConv fused tiles")):
        launches, forwards, wall = run_cli(tmp, [
            "infer-baseline", "--layer_name", "GATConv", "--hidden",
            str(HIDDEN), "--num_test_samples", "8", "--output_dir", out_dir],
            MODE_ENV[mode])
        print(f"serve {out_dir}: infer-baseline took {wall:.1f} s, "
              f"{forwards} forwards")
        check(forwards > 0, "no forward ran")
        expect(launches, {k: v * forwards for k, v in EVAL[mode].items()},
               f"serve {out_dir}")
        with open(os.path.join(tmp, "inference_results",
                               "node_cls.csv")) as f:
            lines = f.read().splitlines()
        row = dict(zip(lines[0].split(","), lines[-1].split(",")))
        check(row["layer_name"] == "GATConv"
              and float(row["avg_inf_time_device"]) > 0,
              f"bad GAT serve row {lines[-1]}")
        print(f"{out_dir} avg_inf_time={row['avg_inf_time']} "
              f"avg_inf_time_device={row['avg_inf_time_device']} "
              f"acc={row['acc']}")
        phases[f"serve {out_dir}"] = launches
    return phases


def phase_serve(device, tmp, g) -> tuple:
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.utils.results import INFERENCE_HEADER

    launches, forwards, wall = run_cli(tmp, [
        "infer-baseline", "--hidden", str(HIDDEN), "--num_test_samples",
        "8"])
    print(f"serve: infer-baseline took {wall:.1f} s, {forwards} forwards")
    check(forwards > 0, "no forward ran")
    expect(launches, {"K1": 2 * forwards, "K3": 2 * forwards}, "serve GCN")

    with open(os.path.join(tmp, "inference_results", "node_cls.csv")) as f:
        lines = f.read().splitlines()
    check(lines[0] == INFERENCE_HEADER,
          f"CSV not written under INFERENCE_HEADER: {lines[:2]}")
    row = dict(zip(lines[0].split(","), lines[-1].split(",")))
    avg, avg_dev = float(row["avg_inf_time"]), float(row["avg_inf_time_device"])
    check(row["layer_name"] == "GCNConv" and np.isfinite(avg) and avg > 0
          and np.isfinite(avg_dev) and avg_dev > 0,
          f"bad GCN serve row {lines[-1]}")
    print(f"avg_inf_time={avg} avg_inf_time_device={avg_dev} "
          f"acc={row['acc']} avg_loss={row['avg_loss']}")

    # the same forward (same graph, same seed-0 init) with kernels, then
    # with the plain versions on the card
    model = NodeModel("GCNConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    gd = g.to(device)
    with torch.inference_mode():
        out_k = model(gd.x, gd)
        with plain_versions():
            out_p = model(gd.x, gd)
    torch.cuda.synchronize()
    check(out_k.shape == (g.num_nodes_padded, NUM_CLASSES),
          f"log-probs shape {tuple(out_k.shape)}")
    check(bool(torch.isfinite(out_k).all()), "non-finite log-probs")
    psum = out_k.exp().sum(-1)
    check(bool(((psum - 1).abs() < 1e-4).all()), "rows are not distributions")
    err = float((out_k - out_p).abs().max())
    print(f"forward kernels vs plain: max_abs_err={err:.3e} (atol 1e-4)")
    check(err <= 1e-4, "forward with kernels disagrees with plain forward")
    return {"serve gcn": launches}, avg, avg_dev


# the curriculum phase: (output dir, layer, setup, gradient method, epochs1,
# epochs2); the Gc epochs launch the confirmed STEP + EVAL counts each, the
# Gs epochs and evals none
CURRICULUM = (
    ("cur_gcn", "GCNConv", "Gc_train_2_Gs_infer", "GD", 2, 0),
    ("cur_gcn_gd", "GCNConv", "Gc_train_2_Gs_train", "GD", 1, 1),
    ("cur_gcn_mb", "GCNConv", "Gc_train_2_Gs_train", "MB", 1, 1),
    ("cur_gcn_gs", "GCNConv", "Gs_train_2_Gs_infer", "GD", 0, 1),
    ("cur_gat", "GATConv", "Gc_train_2_Gs_infer", "GD", 1, 0))
# subgraphs held on the card against the CPU (the batched dense branch)
CURRICULUM_CHECK_SUBGRAPHS = 4096


def phase_curriculum(device, tmp, serve_avg, serve_avg_dev) -> dict:
    """The FIT-GNN curriculum through the port's CLI on the bench graph at
    hidden 512: the partition (computed once, then from the cache), the
    runs of ``CURRICULUM``, the subgraph ``infer`` from the first run's
    checkpoint beside the GCN ``infer-baseline`` row, and the batched Gs
    eval forward on the card against the CPU's."""
    from fitgnn_tpu_torch.graph import optimize as optimize_mod
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.partition import pipeline
    from fitgnn_tpu_torch.train import loop
    from fitgnn_tpu_torch.train.checkpoint import restore_params
    from fitgnn_tpu_torch.utils.results import (INFERENCE_HEADER,
                                                TRAIN_NODE_CLS_HEADER)

    seen = {"partitions": [], "gc": [], "runs": []}
    partition, optimize, run_task = (pipeline.coarsen_and_partition,
                                     optimize_mod.optimize_coarse,
                                     loop.run_node_task)

    def timed_partition(*args, **kwargs):
        t0 = time.perf_counter()
        part = partition(*args, **kwargs)
        seen["partitions"].append((time.perf_counter() - t0, part))
        return part

    def traced_optimize(coarse, **kwargs):
        out = optimize(coarse, **kwargs)
        hyb = out.graph.aux
        seen["gc"].append((int(out.graph.n_node), out.graph.num_nodes_padded,
                           0 if hyb.bsr is None else hyb.bsr.nnz_blocks,
                           hyb.num_coo_edges))
        return out

    def traced_run(cfg, coarse, batch, verbose=False):
        res = run_task(cfg, coarse, batch, verbose=verbose)
        seen.setdefault("batch", batch)     # the first run's, on the host
        seen["runs"].append(res)
        return res

    phases, rows, times = {}, {}, {}
    patches = (mock.patch.object(pipeline, "coarsen_and_partition",
                                 timed_partition),
               mock.patch.object(optimize_mod, "optimize_coarse",
                                 traced_optimize),
               mock.patch.object(loop, "run_node_task", traced_run))
    for patch in patches:
        patch.start()
    try:
        for i, (out_dir, layer, setup, method, ep1, ep2) in enumerate(
                CURRICULUM):
            torch.cuda.reset_peak_memory_stats()
            launches, _, wall = run_cli(tmp, [
                "train", "--layer_name", layer, "--hidden", str(HIDDEN),
                "--exp_setup", setup, "--gradient_method", method,
                "--epochs1", str(ep1), "--epochs2", str(ep2), "--runs", "1",
                "--output_dir", out_dir])
            if i == 0:
                check(len(seen["partitions"]) == 1,
                      "the first curriculum run did not partition")
                secs, part = seen["partitions"][0]
                b = part.subgraphs
                print(f"curriculum partition: {secs:.2f} s host, "
                      f"{part.num_metanodes} metanodes, Gc "
                      f"{int(part.coarse.graph.n_node)} nodes; subgraph "
                      f"batch (S, N_pad, E_pad) = ({b.num_subgraphs}, "
                      f"{b.num_nodes_padded}, {b.senders.shape[1]})")
                del part, b
            else:
                check(len(seen["partitions"]) == 1,
                      f"curriculum {out_dir} did not take the partition "
                      "from the cache")
            want = {k: ep1 * (STEP[layer].get(k, 0) + EVAL[layer].get(k, 0))
                    for k in (*STEP[layer], *EVAL[layer])}
            expect(launches, want, f"curriculum {out_dir}")
            res = seen["runs"][-1].runs[0]
            check(np.isfinite(res.test_loss) and res.test_loss > 0,
                  f"curriculum {out_dir}: test loss {res.test_loss}")
            gc_ms = [round(t * 1e3, 3) for t in res.gc_epoch_seconds]
            gs_s = [round(t, 4) for t in res.gs_epoch_seconds]
            times[out_dir] = (gc_ms, gs_s, res.test_time)
            if ep1:
                n, n_pad, tiles, stragglers = seen["gc"][-1]
                print(f"curriculum {out_dir}: Gc {n} nodes (N_pad {n_pad}): "
                      f"{tiles} tiles, {stragglers} straggler edges")
                check(tiles > 0 and stragglers > 0,
                      f"curriculum {out_dir}: Gc took no hybrid operator")
            print(f"curriculum {out_dir}: {wall:.1f} s; Gc epoch ms "
                  f"{gc_ms}; Gs epoch s {gs_s} ({method}); test eval "
                  f"{res.test_time * 1e3:.3f} ms; test loss "
                  f"{res.test_loss:.4f} metric {res.test_acc:.4f}; peak "
                  f"device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            ckpt = os.path.join(tmp, "save", "node_cls", out_dir, "model.pt")
            check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
            phases[f"curriculum {out_dir}"] = launches
    finally:
        for patch in patches:
            patch.stop()
    batch = seen.pop("batch")
    del seen

    with open(os.path.join(tmp, "results", "bench.csv")) as f:
        header, *lines = f.read().splitlines()
    check(header == TRAIN_NODE_CLS_HEADER and len(lines) == len(CURRICULUM),
          f"curriculum CSV not written under the header: {header}")
    for line in lines:
        row = dict(zip(header.split(","), line.split(",")))
        check(np.isfinite(float(row["best_loss"])) and
              float(row["ave_time"]) > 0, f"bad curriculum row {line}")

    # serve each sampled node from its subgraph: no kernel launches
    launches, forwards, wall = run_cli(tmp, [
        "infer", "--hidden", str(HIDDEN), "--num_test_samples", "64",
        "--output_dir", "cur_gcn"])
    expect(launches, {}, "curriculum infer")
    phases["curriculum infer"] = launches
    with open(os.path.join(tmp, "inference_results", "node_cls.csv")) as f:
        lines = f.read().splitlines()
    check(lines[0] == INFERENCE_HEADER, "infer CSV header")
    row = dict(zip(lines[0].split(","), lines[-1].split(",")))
    avg, avg_dev = float(row["avg_inf_time"]), float(row["avg_inf_time_device"])
    check(row["exp_setup"] == "fitgnn" and avg > 0 and avg_dev > 0
          and np.isfinite(float(row["acc"])), f"bad infer row {lines[-1]}")
    print(f"curriculum infer: {wall:.1f} s, {forwards} forwards")
    print(f"serve GCN hidden {HIDDEN}: subgraph infer avg_inf_time={avg} "
          f"avg_inf_time_device={avg_dev} acc={row['acc']} | "
          f"infer-baseline avg_inf_time={serve_avg} "
          f"avg_inf_time_device={serve_avg_dev} | ratio "
          f"{serve_avg / avg:.1f}x wall, {serve_avg_dev / avg_dev:.1f}x "
          "device")

    # the batched Gs eval forward on the card against the CPU's
    sub = batch.slice(0, CURRICULUM_CHECK_SUBGRAPHS)
    for layer, out_dir in (("GCNConv", "cur_gcn"), ("GATConv", "cur_gat")):
        model = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES)
        model.load_state_dict(restore_params(
            os.path.join(tmp, "save", "node_cls", out_dir, "model.pt")))
        model.eval()
        with torch.inference_mode():
            ref = model(sub.x, sub.graphs())
            reset_counts()
            got = model.to(device)(sub.x.to(device),
                                   sub.graphs().to(device)).cpu()
            expect(read_counts(), {}, f"curriculum {layer} batched forward")
        compare(f"curriculum {layer} batched Gs forward, {sub.num_subgraphs} "
                "subgraphs, cuda vs cpu", got, ref)
    return phases, (avg, avg_dev), times


# phase 9: the extra-node curriculum in size buckets.  The padded rows the
# port's own coarsen and extract_subgraphs give this partition
# (variation_neighborhoods, ratio 0.5, extra_node, seed 0) on the CPU:
# bucketed (caps 32 / 64 / 128 at N_pad 40 / 72 / 104) and with one pad for
# every subgraph (N_pad 104)
BUCKET_ROWS = 3_615_960
SINGLE_PAD_ROWS = 8_814_936
BUCKET_EVAL_CHUNK = 8192
BUCKET_FLAGS = ["--extra_node", "--bucket_sizes", "--hidden", str(HIDDEN),
                "--runs", "1"]
BUCKET_GD = ["--layer_name", "GCNConv", "--exp_setup", "Gc_train_2_Gs_train",
             "--fused_epochs", "--eval_chunk", str(BUCKET_EVAL_CHUNK),
             "--checkpoint_every", "1", "--epochs1", "3", "--epochs2", "2"]


# cycles of torch.cuda._sleep in the fused phase's probe (~0.5 s at the
# H100's SM clock), far longer than the host takes to launch 2 epochs
PROBE_CYCLES = 1_000_000_000


class Interrupted(Exception):
    """The crash a resume check simulates."""


def phase_buckets(device, tmp, plain_infer, warmed) -> dict:
    """The extra-node curriculum on size-bucketed batches through the
    port's CLI at hidden 512: GCN ``Gc_train_2_Gs_train`` in GD (the
    partition that phase 17's ``save-graphs`` computed, ``warmed`` = its
    host seconds and itself, loaded from the cache, never computed here)
    and in MB, each
    with the fused Gc phase, the chunked eval and a resume checkpoint an
    epoch; GAT ``Gc_train_2_Gs_infer`` with the fused Gc phase; GCN
    ``Gc_train_2_Gs_infer`` with and without ``--fused_epochs`` (the fused
    phase under ``set_sync_debug_mode("error")``), which must agree; the GD
    run again, cut after its Gs epoch 0 and taken up with ``--resume``; the
    eval of every bucket at once against the chunked one on the card; and
    the bucketed ``infer``."""
    from fitgnn_tpu_torch.bench import inference as inference_mod
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.partition import pipeline
    from fitgnn_tpu_torch.train import checkpoint as ckpt_mod
    from fitgnn_tpu_torch.train import loop, steps
    from fitgnn_tpu_torch.train.checkpoint import restore_params
    from fitgnn_tpu_torch.utils.results import INFERENCE_HEADER

    seen = {"partitions": [], "runs": []}
    partition, run_task = pipeline.coarsen_and_partition, loop.run_node_task

    def timed_partition(*args, **kwargs):
        t0 = time.perf_counter()
        part = partition(*args, **kwargs)
        seen["partitions"].append((time.perf_counter() - t0, part))
        return part

    def traced_run(cfg, coarse, batch, verbose=False):
        res = run_task(cfg, coarse, batch, verbose=verbose)
        seen["runs"].append(res.runs[0])
        return res

    phases = {}

    def train(out_dir, argv, layer, epochs1, env=None):
        """One ``train`` run: its launches against the Gc phase's
        ``epochs1 × (STEP + EVAL)`` (the Gs phase launches none), its
        peak device memory; returns its ``RunResult``."""
        torch.cuda.reset_peak_memory_stats()
        launches, _, wall = run_cli(tmp, ["train", *BUCKET_FLAGS, *argv,
                                          "--output_dir", out_dir], env)
        want = {k: epochs1 * (STEP[layer].get(k, 0) + EVAL[layer].get(k, 0))
                for k in (*STEP[layer], *EVAL[layer])}
        expect(launches, want, f"buckets {out_dir}")
        phases[f"buckets {out_dir}"] = launches
        res = seen["runs"][-1]
        check(np.isfinite(res.test_loss) and res.test_loss > 0,
              f"buckets {out_dir}: test loss {res.test_loss}")
        fused = ("" if res.gc_fused_seconds is None else
                 f"fused Gc {res.gc_fused_seconds * 1e3 / epochs1:.3f} ms "
                 f"an epoch ({epochs1} in {res.gc_fused_seconds:.3f} s); ")
        print(f"buckets {out_dir}: {wall:.1f} s; {fused}Gc epoch ms "
              f"{[round(t * 1e3, 3) for t in res.gc_epoch_seconds]}; Gs "
              f"epoch s {[round(t, 4) for t in res.gs_epoch_seconds]}; "
              f"test eval {res.test_time * 1e3:.3f} ms; test loss "
              f"{res.test_loss:.6f} metric {res.test_acc:.6f}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return res

    strict_calls, probe = [], []
    fused_fn = steps.gc_train_epochs_fused

    def strict_fused(*args, **kwargs):
        """The fused Gc phase with any host synchronization an error.  In
        the probe run the device is first kept busy for ``PROBE_CYCLES``
        (``torch.cuda._sleep``), so a phase that waited for the device
        anywhere would return to the host only after that; the host
        seconds until it returns and until the device is done are
        recorded."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if probe:
            torch.cuda._sleep(PROBE_CYCLES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fused_fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        returned = time.perf_counter() - t0
        torch.cuda.synchronize()
        strict_calls.append((returned, time.perf_counter() - t0))
        print(f"fused Gc phase{' (probe)' if probe else ''}: returned to "
              f"the host after {returned * 1e3:.3f} ms, the device done "
              f"after {strict_calls[-1][1] * 1e3:.3f} ms")
        return out

    save_fn = ckpt_mod.save_resume

    def save_then_crash(*args, **kwargs):
        save_fn(*args, **kwargs)
        if args[6:8] == ("gs", 0):           # phase, epoch
            raise Interrupted("after Gs epoch 0's checkpoint")

    patches = (mock.patch.object(pipeline, "coarsen_and_partition",
                                 timed_partition),
               mock.patch.object(loop, "run_node_task", traced_run),
               mock.patch.object(steps, "gc_train_epochs_fused",
                                 strict_fused))
    for patch in patches:
        patch.start()
    try:
        # (1) GCN GD: the partition from the cache save-graphs warmed
        gd = train("buck_gd", ["--gradient_method", "GD", *BUCKET_GD],
                   "GCNConv", 3)
        check(not seen["partitions"], "the first bucketed run partitioned: "
              "save-graphs left the cache cold")
        secs, part = warmed
        batches = part.subgraphs
        check(isinstance(batches, tuple) and len(batches) >= 2,
              f"the extra-node partition gave {len(batches)} buckets")
        rows = sum(b.num_subgraphs * b.num_nodes_padded for b in batches)
        n_max = max(int(b.n_node.max()) for b in batches)
        n_single = max(-(-(n_max + 1) // 8) * 8, 8)
        single = part.num_metanodes * n_single
        shapes = [(b.num_subgraphs, b.num_nodes_padded, b.senders.shape[1])
                  for b in batches]
        print(f"buckets partition: {secs:.2f} s host, {part.num_metanodes} "
              f"subgraphs in {len(batches)} buckets, (S, N_pad, E_pad) "
              f"{shapes}; "
              f"padded rows {rows} bucketed, {single} with one pad (N_pad "
              f"{n_single}): {single / rows:.2f}x")
        check(rows < single, "bucketing padded no fewer rows")
        for got, ref, what in ((rows, BUCKET_ROWS, "bucketed"),
                               (single, SINGLE_PAD_ROWS, "single-pad")):
            check(abs(got - ref) <= 0.01 * ref,
                  f"{what} padded rows {got}, expected {ref} within 1%")
        check(gd.gc_fused_seconds is not None and len(gd.gs_epoch_seconds)
              == 2, "buck_gd did not run the fused Gc phase and 2 Gs epochs")
        del part
        # (2) GCN MB, from the cache
        train("buck_mb", ["--gradient_method", "MB", *BUCKET_GD], "GCNConv",
              3)
        # (3) GAT with the fused Gc phase
        gat = train("buck_gat", [
            "--layer_name", "GATConv", "--exp_setup", "Gc_train_2_Gs_infer",
            "--fused_epochs", "--epochs1", "3", "--eval_chunk",
            str(BUCKET_EVAL_CHUNK)], "GATConv", 3)
        check(gat.gc_fused_seconds is not None, "buck_gat was not fused")
        # (4) the fused Gc phase against the per-epoch loop
        n_strict = len(strict_calls)
        pair = {}
        for out_dir, extra in (("buck_fused", ["--fused_epochs"]),
                               ("buck_epochs", [])):
            res = train(out_dir, ["--layer_name", "GCNConv", "--exp_setup",
                                  "Gc_train_2_Gs_infer", "--epochs1", "3",
                                  *extra], "GCNConv", 3)
            with open(os.path.join(tmp, "save", "node_cls", out_dir,
                                   "run_1", "scalars.jsonl")) as f:
                vals = [json.loads(line) for line in f]
            vals = [r["value"] for r in vals if r["tag"] == "Gc_val_loss"]
            pair[out_dir] = (res, vals)
        check(len(strict_calls) == n_strict + 1,
              "the fused run did not run under the sync check")
        # the probe: the fused phase behind a busy device
        probe.append(1)
        train("buck_probe", ["--layer_name", "GCNConv", "--exp_setup",
                             "Gc_train_2_Gs_infer", "--epochs1", "2",
                             "--fused_epochs"], "GCNConv", 2)
        probe.clear()
        returned, done = strict_calls[-1]
        check(returned < 0.5 * done, "the fused Gc phase returned to the "
              f"host after {returned * 1e3:.3f} ms of {done * 1e3:.3f} "
              "behind a busy device: it waited for the device")
        (fres, fvals), (eres, evals) = pair["buck_fused"], pair["buck_epochs"]
        print(f"fused vs per-epoch Gc: val losses {fvals} / {evals}; best "
              f"{min(fvals):.6f} / {min(evals):.6f}; test loss "
              f"{fres.test_loss:.6f} / {eres.test_loss:.6f}; Gc "
              f"{fres.gc_fused_seconds * 1e3 / 3:.3f} ms an epoch fused, "
              f"{[round(t * 1e3, 3) for t in eres.gc_epoch_seconds]} ms "
              "per epoch")
        check(len(fvals) == len(evals) == 3
              and np.allclose(fvals, evals, rtol=RTOL, atol=0)
              and np.isclose(min(fvals), min(evals), rtol=RTOL, atol=0)
              and np.isclose(fres.test_loss, eres.test_loss, rtol=RTOL,
                             atol=0),
              "the fused Gc phase disagrees with the per-epoch loop")
        # (5) resume: (1) cut after Gs epoch 0, then taken up
        with mock.patch.object(ckpt_mod, "save_resume", save_then_crash):
            try:
                run_cli(tmp, ["train", *BUCKET_FLAGS, "--gradient_method",
                              "GD", *BUCKET_GD, "--output_dir",
                              "buck_resume"])
            except Interrupted:
                cut = read_counts()
            else:
                check(False, "the resume run was not interrupted")
        expect(cut, {k: 3 * (STEP["GCNConv"][k] + EVAL["GCNConv"][k])
                     for k in STEP["GCNConv"]},
               "buckets buck_resume, cut after Gs epoch 0")
        phases["buckets buck_resume cut"] = cut
        resumed = train("buck_resume", ["--gradient_method", "GD",
                                         *BUCKET_GD, "--resume"],
                        "GCNConv", 0)
        print(f"resumed vs uninterrupted: test loss {resumed.test_loss:.6f} "
              f"/ {gd.test_loss:.6f}, metric {resumed.test_acc:.6f} / "
              f"{gd.test_acc:.6f}; Gs epochs run "
              f"{len(resumed.gs_epoch_seconds)}")
        check(len(resumed.gs_epoch_seconds) == 1
              and np.isclose(resumed.test_loss, gd.test_loss, rtol=1e-3,
                             atol=0)
              and np.isclose(resumed.test_acc, gd.test_acc, rtol=1e-3,
                             atol=0),
              "the resumed run disagrees with the uninterrupted one")
        check(not seen["partitions"], "a bucketed train partitioned: the "
              "cache save-graphs warmed was not read")
    finally:
        for patch in patches:
            patch.stop()

    # the eval of every bucket at once against the chunked one, on the card
    model = NodeModel("GCNConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES)
    model.load_state_dict(restore_params(
        os.path.join(tmp, "save", "node_cls", "buck_gd", "model.pt")))
    model = model.to(device)
    on_card = tuple(b.to(device) for b in batches)
    del batches
    cfg = loop.NodeTaskConfig(hidden=HIDDEN, device="cuda")
    evals = {}
    for chunk in (0, BUCKET_EVAL_CHUNK):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        evals[chunk] = loop._gs_eval(model, on_card, dataclasses.replace(
            cfg, eval_chunk=chunk), "test")
        secs = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        print(f"buckets eval {'chunk ' + str(chunk) if chunk else 'whole'}: "
              f"loss {evals[chunk][0]:.6f} metric {evals[chunk][1]:.6f}, "
              f"{secs:.3f} s, peak device memory above the batches "
              f"{peak:.2f} GiB")
    check(np.allclose(evals[0], evals[BUCKET_EVAL_CHUNK], rtol=RTOL, atol=0),
          "the chunked eval disagrees with the whole-bucket eval")
    del on_card, model
    torch.cuda.empty_cache()

    # (6) the bucketed infer: which buckets its samples fall in
    sampled = {}
    bench_fn = inference_mod.node_inference_benchmark

    def traced_bench(model, batch, parent, test_mask, y, num_samples=100,
                     classify=True, seed=0, subgraph_index=None):
        nodes = inference_mod._sample_nodes(np.asarray(test_mask, bool),
                                            num_samples, seed)
        b, c = np.unique(subgraph_index[parent[nodes], 0],
                         return_counts=True)
        sampled.update(zip(b.tolist(), c.tolist()))
        return bench_fn(model, batch, parent, test_mask, y, num_samples,
                        classify, seed, subgraph_index)

    with mock.patch.object(inference_mod, "node_inference_benchmark",
                           traced_bench):
        launches, forwards, wall = run_cli(tmp, [
            "infer", "--extra_node", "--bucket_sizes", "--hidden",
            str(HIDDEN), "--num_test_samples", "64", "--output_dir",
            "buck_gd"])
    expect(launches, {}, "buckets infer")
    phases["buckets infer"] = launches
    with open(os.path.join(tmp, "inference_results", "node_cls.csv")) as f:
        lines = f.read().splitlines()
    check(lines[0] == INFERENCE_HEADER, "infer CSV header")
    row = dict(zip(lines[0].split(","), lines[-1].split(",")))
    avg = float(row["avg_inf_time"])
    avg_dev = float(row["avg_inf_time_device"])
    check(row["extra_nodes"] == "True" and avg > 0 and avg_dev > 0
          and np.isfinite(float(row["acc"])), f"bad infer row {lines[-1]}")
    check(sum(sampled.values()) == 64, f"sampled buckets {sampled}")
    print(f"buckets infer: {wall:.1f} s, {forwards} forwards, samples by "
          f"bucket {sampled}; avg_inf_time={avg} avg_inf_time_device="
          f"{avg_dev} acc={row['acc']} | plain-mode infer (phase 8) "
          f"avg_inf_time={plain_infer[0]} avg_inf_time_device="
          f"{plain_infer[1]}")
    return phases


# phase 10: SAGE and GIN on every entry point, and layer-0 pre-aggregation
SAGE_GIN = ("SAGEConv", "GINConv")
# the aggregate of a pre-aggregated stack, computed once at ingest
PREAGG_INGEST = {"K1": 1, "K3": 1}
SAGE_GIN_EPOCHS = 2
# SAGE's step on its use_diag operator: K3 → K8 → K1 in each aggregation
SAGE_DIAG_STEP = {"K3": 3, "K8": 3, "K1": 3}


def phase_sage_gin_kernels(device, ds, gcn_split) -> tuple:
    """Phase 10's operators and kernels: ``build_optimized_graph`` for SAGE
    and GIN on the bench graph (their split must be GCN's), K3 then K1 on
    each at F=128 and 512, forward and on the transpose structures, and K8
    from ``init`` on SAGE's ``use_diag`` diagonal blocks (not symmetric),
    both orientations, each against its plain version.  Returns the two
    graphs (CPU), SAGE's ``use_diag`` operator and the rows."""
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm, diag_spmm_plain

    graphs, shapes = {}, {"K1": [], "K3": [], "K8": []}
    gen = torch.Generator(device=device).manual_seed(10)
    for layer in SAGE_GIN:
        t0 = time.perf_counter()
        g, _ = build_optimized_graph(ds.x, ds.senders, ds.receivers,
                                     y=ds.y, train_mask=ds.train_mask,
                                     layer_name=layer, seed=0)
        h = g.aux
        print(f"{layer} ingest: {time.perf_counter() - t0:.1f} s; "
              f"semantics {h.semantics}: {h.bsr.nnz_blocks} tiles (with "
              f"fillers), {h.num_coo_edges} straggler edges, "
              f"{int((h.weights != 0).sum())} of weight != 0 (GCN: "
              f"{gcn_split[2]} tiles, {gcn_split[3]} straggler edges)")
        check(torch.equal(h.bsr.rows, gcn_split[0])
              and torch.equal(h.bsr.cols, gcn_split[1])
              and h.bsr.nnz_blocks == gcn_split[2]
              and h.num_coo_edges == gcn_split[3],
              f"{layer}: the operator does not split as GCN's")
        graphs[layer] = g
        hd = h.to(device)
        n = g.num_nodes_padded
        xs = {f: torch.randn((n, f), generator=gen, device=device)
              for f in (NUM_FEATURES, HIDDEN)}
        for trans in (False, True):
            tag = f"{layer}{' transpose' if trans else ''}"
            rows = k1_k3_rows(hd.bsr.transpose if trans else hd.bsr,
                              hd.t_segmm if trans else hd.segmm, n, xs, tag)
            for k, v in rows.items():
                for row in v:
                    row["on_path"] = False    # GCN's rows carry the times
                shapes[k].extend(v)
        del hd, xs

    t0 = time.perf_counter()
    gdiag, _ = build_optimized_graph(ds.x, ds.senders, ds.receivers,
                                     y=ds.y, train_mask=ds.train_mask,
                                     layer_name="SAGEConv", seed=0,
                                     use_diag=True)
    check(torch.equal(gdiag.senders, graphs["SAGEConv"].senders),
          "SAGE use_diag: node order differs from the default operator's")
    hdiag = gdiag.aux
    diag, r8 = hdiag.diag_blocks.to(device), hdiag.diag_r
    n = gdiag.num_nodes_padded
    nb = n // 128
    asym = float((diag - diag.transpose(1, 2)).abs().max())
    print(f"SAGE use_diag ingest: {time.perf_counter() - t0:.1f} s; "
          f"{diag.shape[0]} diagonal blocks, diag_r={r8}, "
          f"max |D - Dᵀ| {asym:.4f}")
    check(r8 > 0 and hdiag.bsr is not None and asym > 0,
          "SAGE use_diag: expected the K8 chain on asymmetric blocks")
    diag_live = int((diag != 0).flatten(1).any(1).sum())
    diag_nnz = int((diag != 0).sum())
    with torch.inference_mode():
        for feat, transpose in ((NUM_FEATURES, False), (HIDDEN, False),
                                (HIDDEN, True)):
            x = torch.randn((n, feat), generator=gen, device=device)
            init = torch.randn((n, feat), generator=gen, device=device)
            tag = (f"SAGEConv F={feat}{' transpose' if transpose else ''} "
                   "init")
            got = diag_spmm(diag, x, r8, transpose, init)
            ref = diag_spmm_plain(diag, x, r8, transpose, init)
            torch.cuda.synchronize()
            err = compare(f"K8 diag_spmm {tag}", got, ref)
            a3 = diag.transpose(1, 2) if transpose else diag
            x3, i3 = x.reshape(nb, 128, feat), init.reshape(nb, 128, feat)
            b8, by8 = bound(diag_live * 128 * 128 * 4 + n * feat * 4 * 3,
                            2.0 * diag_nnz * feat)
            shapes["K8"].append(dict(
                F=feat, shape=tag, transpose=transpose, init=True,
                operator="SAGEConv use_diag", on_path=False, **err,
                bound_ms=b8, bound_by=by8,
                ms=cuda_ms(lambda: diag_spmm(diag, x, r8, transpose, init),
                           20),
                plain_ms=cuda_ms(lambda: diag_spmm_plain(
                    diag, x, r8, transpose, init), 5),
                library_ms=cuda_ms(lambda: torch.baddbmm(i3, a3, x3), 20)))
            sh = shapes["K8"][-1]
            print(f"  K8 {tag}: kernel_ms={sh['ms']:.4f} plain_ms="
                  f"{sh['plain_ms']:.4f} library_ms={sh['library_ms']:.4f} "
                  f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']})")
            del x, init, got, ref, x3, i3
    torch.cuda.empty_cache()
    return graphs, hdiag, shapes


class ReluMasks:
    """GIN's ReLUs: ``record`` keeps each ``F.relu``'s mask in a run,
    ``replay`` applies them in order in a second run and counts the
    pre-activations whose sign differs there.  A pre-activation within
    rounding of 0 may take the other side of the kink in another order of
    sums, and the gradient then changes by that unit's whole term: the
    replayed run's gradients differ from the first's by the order of the
    sums alone, so they are held at the tolerance of the others."""

    def __init__(self):
        self.masks, self.flips, self.flip_max, self.z_max = [], 0, 0.0, 0.0

    @contextlib.contextmanager
    def record(self):
        def relu(z, inplace=False):
            self.masks.append(z.detach() > 0)
            return torch.relu(z)

        with mock.patch.object(torch.nn.functional, "relu", relu):
            yield

    @contextlib.contextmanager
    def replay(self):
        it = iter(self.masks)

        def relu(z, inplace=False):
            m = next(it)
            if m.shape[0] < z.shape[0]:
                # recorded on fewer rows (phase 19's rank holds no padding
                # rows): the rows past them keep their own signs
                m = torch.cat([m, z.detach()[m.shape[0]:] > 0])
            diff = (z.detach() > 0) != m
            self.flips += int(diff.sum())
            self.z_max = max(self.z_max, float(z.detach().abs().max()))
            if diff.any():
                self.flip_max = max(self.flip_max,
                                    float(z.detach()[diff].abs().max()))
            return z * m

        with mock.patch.object(torch.nn.functional, "relu", relu):
            yield
        check(next(it, None) is None, "ReluMasks: a ReLU was not replayed")

    def report(self, what: str) -> None:
        if not self.masks:
            return
        print(f"{what}: {len(self.masks)} ReLUs replayed, {self.flips} "
              f"pre-activations on the other side of 0, the largest "
              f"|z| {self.flip_max:.3e} of max |z| {self.z_max:.3e}")
        check(self.flip_max <= 1e-5 * self.z_max,
              f"{what}: a ReLU flipped away from its kink")


def phase_sage_gin_gradients(device, graphs, hdiag) -> None:
    """One SAGE and one GIN step (hidden 512, dropout off, seed-0 init)
    with the kernels and with the plain versions (GIN's ReLU masks
    replayed, ``ReluMasks``): the loss and every gradient (GIN's ``eps``
    included), the launches of the step and of an eval forward; the pre-aggregated model's step and forward against the
    plain model's; SAGE's step on its ``use_diag`` operator (K8 both ways)
    against the default operator's."""
    from fitgnn_tpu_torch.models.models import NodeModel, preaggregate_input
    from fitgnn_tpu_torch.train.losses import masked_nll

    for layer in SAGE_GIN:
        gd = graphs[layer].to(device)

        def model_for(pre=False):
            m = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                          dropout_rate=0.0, first_layer_preaggregated=pre)
            m.reset_parameters(torch.Generator().manual_seed(0))
            return m.to(device).train()

        def step(model, x, g):
            model.zero_grad(set_to_none=True)
            loss = masked_nll(model(x, g), gd.y, gd.train_mask)
            loss.backward()
            torch.cuda.synchronize()
            return loss.detach(), {k: p.grad.detach().clone()
                                   for k, p in model.named_parameters()}

        def eval_forward(model, x, g):
            model.eval()
            with torch.inference_mode():
                out = model(x, g)
            torch.cuda.synchronize()
            model.train()
            return out

        model = model_for()
        relus = ReluMasks()
        reset_counts()
        with relus.record():
            loss_k, grads_k = step(model, gd.x, gd)
        expect(read_counts(), STEP[layer], f"{layer} train step")
        reset_counts()
        out_k = eval_forward(model, gd.x, gd)
        expect(read_counts(), EVAL[layer], f"{layer} eval forward")
        reset_counts()
        with plain_versions(), relus.replay():
            loss_p, grads_p = step(model, gd.x, gd)
        expect(read_counts(), {}, f"{layer} train step, plain versions")
        relus.report(f"{layer} step, plain versions")
        compare(f"{layer} loss kernels vs plain", loss_k.reshape(1),
                loss_p.reshape(1))
        for k in grads_p:
            compare(f"{layer} grad {k}", grads_k[k].reshape(-1),
                    grads_p[k].reshape(-1))

        mode = f"{layer} preaggregated"
        reset_counts()
        with torch.no_grad():
            x_pre = preaggregate_input(gd, layer)
        torch.cuda.synchronize()
        expect(read_counts(), PREAGG_INGEST, f"{mode} ingest")
        pre = model_for(pre=True)
        reset_counts()
        loss_pre, grads_pre = step(pre, x_pre, gd)
        expect(read_counts(), STEP[mode], f"{mode} train step")
        reset_counts()
        out_pre = eval_forward(pre, x_pre, gd)
        expect(read_counts(), EVAL[mode], f"{mode} eval forward")
        compare(f"{mode} eval forward vs the plain model's", out_pre, out_k)
        compare(f"{mode} loss vs the plain model's", loss_pre.reshape(1),
                loss_k.reshape(1))
        for k in grads_k:
            compare(f"{mode} grad {k} vs the plain model's",
                    grads_pre[k].reshape(-1), grads_k[k].reshape(-1))
        del pre, x_pre, out_pre, grads_pre

        if layer == "SAGEConv":
            gdiag = gd._replace(aux=hdiag.to(device))
            reset_counts()
            loss_d, grads_d = step(model, gdiag.x, gdiag)
            expect(read_counts(), SAGE_DIAG_STEP, "SAGEConv use_diag step")
            compare("SAGEConv use_diag loss vs the default operator's",
                    loss_d.reshape(1), loss_k.reshape(1))
            for k in grads_k:
                compare(f"SAGEConv use_diag grad {k} vs the default "
                        "operator's", grads_d[k], grads_k[k])
            del gdiag, grads_d
        del model, gd, grads_k, grads_p, out_k
        torch.cuda.empty_cache()


def phase_sage_gin_cli(device, tmp, graphs) -> dict:
    """``train --baseline`` for SAGE and GIN at hidden 512, plain and with
    ``--preaggregate`` (the aggregate once at ingest), then
    ``infer-baseline`` from each checkpoint (the pre-aggregated one loaded
    into the plain model) and its forward with kernels against the plain
    versions; then the curriculum ``Gc_train_2_Gs_train`` GD for 1 + 1
    epochs on phase 8's cached plain partition, and ``infer`` from SAGE's
    checkpoint."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.partition import pipeline
    from fitgnn_tpu_torch.train import loop
    from fitgnn_tpu_torch.train.checkpoint import restore_params

    phases, runs = {}, []
    for layer in SAGE_GIN:
        for pre in (False, True):
            out_dir = f"{layer[:-4].lower()}512{'pre' if pre else ''}"
            mode = f"{layer} preaggregated" if pre else layer
            launches, _, wall = run_cli(tmp, [
                "train", "--baseline", "--layer_name", layer, "--hidden",
                str(HIDDEN), "--runs", "1", "--epochs1",
                str(SAGE_GIN_EPOCHS), "--output_dir", out_dir,
                *(["--preaggregate"] if pre else [])])
            print(f"train {out_dir}: {wall:.1f} s")
            want = {k: SAGE_GIN_EPOCHS * (STEP[mode][k] + EVAL[mode][k])
                    + 2 * EVAL[mode][k]
                    + (PREAGG_INGEST[k] if pre else 0) for k in STEP[mode]}
            expect(launches, want, f"train {out_dir}")
            ckpt = os.path.join(tmp, "save", "node_cls", "baseline",
                                out_dir, "model.pt")
            check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
            phases[f"train {out_dir}"] = launches
            runs.append((layer, out_dir))
    with open(os.path.join(tmp, "results", "baseline", "bench.csv")) as f:
        header, *lines = f.read().splitlines()
    for line in lines[-len(runs):]:
        row = dict(zip(header.split(","), line.split(",")))
        loss = float(row["best_loss"])
        check(row["layer_name"] in SAGE_GIN and np.isfinite(loss)
              and loss > 0, f"bad SAGE/GIN train row {line}")
        print(f"train row: layer={row['layer_name']} best_acc="
              f"{row['best_acc']} best_loss={row['best_loss']} "
              f"ave_time={row['ave_time']}")

    for layer, out_dir in runs:
        launches, forwards, wall = run_cli(tmp, [
            "infer-baseline", "--layer_name", layer, "--hidden", str(HIDDEN),
            "--num_test_samples", "8", "--output_dir", out_dir])
        check(forwards > 0, "no forward ran")
        expect(launches, {k: v * forwards for k, v in EVAL[layer].items()},
               f"serve {out_dir}")
        with open(os.path.join(tmp, "inference_results",
                               "node_cls.csv")) as f:
            lines = f.read().splitlines()
        row = dict(zip(lines[0].split(","), lines[-1].split(",")))
        check(row["layer_name"] == layer
              and float(row["avg_inf_time_device"]) > 0
              and np.isfinite(float(row["avg_loss"])),
              f"bad {layer} serve row {lines[-1]}")
        print(f"serve {out_dir}: infer-baseline took {wall:.1f} s, "
              f"{forwards} forwards; avg_inf_time={row['avg_inf_time']} "
              f"avg_inf_time_device={row['avg_inf_time_device']} "
              f"acc={row['acc']}")
        phases[f"serve {out_dir}"] = launches
        # the served forward (the checkpoint in the plain model), with
        # kernels and with the plain versions
        model = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES)
        model.load_state_dict(restore_params(os.path.join(
            tmp, "save", "node_cls", "baseline", out_dir, "model.pt")))
        model = model.to(device).eval()
        gd = graphs[layer].to(device)
        with torch.inference_mode():
            out_k = model(gd.x, gd)
            with plain_versions():
                out_p = model(gd.x, gd)
        torch.cuda.synchronize()
        check(bool(((out_k.exp().sum(-1) - 1).abs() < 1e-4).all()),
              f"serve {out_dir}: rows are not distributions")
        compare(f"serve {out_dir} forward kernels vs plain", out_k, out_p)
        del model, gd, out_k, out_p

    results, partition, run_task = ([], pipeline.coarsen_and_partition,
                                    loop.run_node_task)

    def traced_run(cfg, coarse, batch, verbose=False):
        res = run_task(cfg, coarse, batch, verbose=verbose)
        results.append(res.runs[0])
        return res

    partitioned = []
    with mock.patch.object(loop, "run_node_task", traced_run), \
            mock.patch.object(pipeline, "coarsen_and_partition",
                              lambda *a, **k: partitioned.append(1)
                              or partition(*a, **k)):
        for layer in SAGE_GIN:
            out_dir = f"cur_{layer[:-4].lower()}"
            launches, _, wall = run_cli(tmp, [
                "train", "--layer_name", layer, "--hidden", str(HIDDEN),
                "--exp_setup", "Gc_train_2_Gs_train", "--gradient_method",
                "GD", "--epochs1", "1", "--epochs2", "1", "--runs", "1",
                "--output_dir", out_dir])
            expect(launches, {k: STEP[layer][k] + EVAL[layer][k]
                              for k in STEP[layer]}, f"curriculum {out_dir}")
            res = results[-1]
            check(np.isfinite(res.test_loss) and res.test_loss > 0,
                  f"curriculum {out_dir}: test loss {res.test_loss}")
            print(f"curriculum {out_dir}: {wall:.1f} s; Gc epoch ms "
                  f"{[round(t * 1e3, 3) for t in res.gc_epoch_seconds]}; "
                  f"Gs epoch s {[round(t, 4) for t in res.gs_epoch_seconds]}"
                  f" (GD); test eval {res.test_time * 1e3:.3f} ms; test "
                  f"loss {res.test_loss:.4f} metric {res.test_acc:.4f}")
            phases[f"curriculum {out_dir}"] = launches
    check(not partitioned, "phase 10's curriculum did not take phase 8's "
          "partition from the cache")
    launches, forwards, wall = run_cli(tmp, [
        "infer", "--layer_name", "SAGEConv", "--hidden", str(HIDDEN),
        "--num_test_samples", "64", "--output_dir", "cur_sage"])
    expect(launches, {}, "curriculum SAGE infer")
    phases["curriculum sage infer"] = launches
    with open(os.path.join(tmp, "inference_results", "node_cls.csv")) as f:
        lines = f.read().splitlines()
    row = dict(zip(lines[0].split(","), lines[-1].split(",")))
    check(row["exp_setup"] == "fitgnn" and row["layer_name"] == "SAGEConv"
          and float(row["avg_inf_time_device"]) > 0
          and np.isfinite(float(row["acc"])), f"bad infer row {lines[-1]}")
    print(f"curriculum SAGE infer: {wall:.1f} s, {forwards} forwards; "
          f"avg_inf_time={row['avg_inf_time']} avg_inf_time_device="
          f"{row['avg_inf_time_device']} acc={row['acc']}")
    return phases


# --- phase 11: bf16 tiles ----------------------------------------------------

def bf16_operators(g) -> dict:
    """The bench graph's operators with bf16 tiles on phase 3's node order
    (``build_hybrid(tile_dtype=torch.bfloat16)``, as
    ``build_optimized_graph`` builds them after its reorder): GCN's
    default, ``use_diag``, ``tile_group=2`` and ``use_rowwalk`` layouts,
    and GAT's ``att_unit`` operator."""
    from fitgnn_tpu_torch.graph.optimize import _operator_weights
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

    s, r = g.senders.numpy(), g.receivers.numpy()
    w, n = g.edge_weight.numpy(), g.num_nodes_padded
    kw = dict(min_block_edges=48, use_segmm=True, tile_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    ops = {name: build_hybrid(s, r, w, n, **kw, **extra)
           for name, extra in (("default", {}), ("diag", dict(use_diag=True)),
                               ("group2", dict(tile_group=2)),
                               ("rowwalk", dict(use_rowwalk=True)))}
    ops["gat"] = build_hybrid(s, r, _operator_weights(s, r, w, n, "att_unit"),
                              n, semantics="att_unit", **kw)
    print(f"bf16 ingest (5 operators): {time.perf_counter() - t0:.1f} s")
    for name, h in ops.items():
        check(h.bsr is not None, f"bf16 {name}: no tile off the diagonal")
        blocks = [h.bsr.blocks, h.bsr.transpose.blocks]
        if h.diag_blocks is not None:
            blocks.append(h.diag_blocks)
        check(all(b.dtype == torch.bfloat16 for b in blocks),
              f"bf16 {name}: the tiles are not bf16")
    b = ops["default"].bsr
    check(torch.equal(b.rows, g.aux.bsr.rows)
          and torch.equal(b.blocks.float(),
                          g.aux.bsr.blocks.to(torch.bfloat16).float()),
          "bf16 default: the tiles are not phase 3's, rounded")
    print(f"bf16 tiles: {b.nnz_blocks} tiles of 32 KiB, "
          f"{b.blocks.numel() * 2 / 2**20:.1f} MiB a direction (f32: "
          f"{b.blocks.numel() * 4 / 2**20:.1f} MiB)")
    return ops


def f32_row(shapes, k, **match) -> dict:
    """The f32 form's row of kernel ``k`` whose keys match ``match``."""
    rows = [sh for sh in shapes.get(k, [])
            if all(sh.get(a) == v for a, v in match.items())]
    check(len(rows) == 1, f"{k}: {len(rows)} f32 rows match {match}")
    return rows[0]


def phase_bf16_kernels(device, ops, shapes) -> dict:
    """Each bf16 form against its plain version on the same bf16 tiles at
    F=128 and 512: K1, K2, K9 and K10 on their layouts, K8 forward and
    transposed with and without init, K7rm, K7f, K7bt's dx walk and K7s's
    pass on GAT's mask (these also bit for bit against their f32 forms on
    the mask widened to f32: it is 0/1, and nothing is rounded).  Each row
    holds its kernel, plain and library times, its bound from the bytes it
    moves (tiles at 2 bytes an entry) and its operations, and the f32
    form's time from phase 3 or 5 beside it."""
    from fitgnn_tpu_torch.ops import att_bsr
    from fitgnn_tpu_torch.ops.bsr_spmm import (bsr_spmm_acc,
                                               bsr_spmm_acc_plain,
                                               bsr_spmm_fwd,
                                               bsr_spmm_grouped,
                                               bsr_spmm_plain,
                                               bsr_spmm_rowwalk)
    from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm, diag_spmm_plain

    b0 = ops["default"].bsr.to(device)
    n = b0.num_row_blocks * 128
    nb = n // 128
    walks = {"K2": (b0, bsr_spmm_fwd),
             "K9": (ops["group2"].bsr.to(device), bsr_spmm_grouped),
             "K10": (ops["rowwalk"].bsr.to(device), bsr_spmm_rowwalk)}
    diag, r8 = ops["diag"].diag_blocks.to(device), ops["diag"].diag_r
    # the library yardsticks: the tiles' CSR with their bf16 values in f32
    # (PyTorch's sparse products take no bf16 matrix beside an f32 x), x
    # rounded to bf16 beforehand where the form rounds it
    a_tiles, nnz = tile_csr(dataclasses.replace(b0, blocks=b0.blocks.float()),
                            n)
    nz_tile = (b0.blocks != 0).flatten(1).any(1)
    tiles, tiles_all = int(nz_tile.sum()), b0.nnz_blocks
    uniq_cols = int(torch.unique(b0.cols[nz_tile]).numel())
    diag_live = int((diag != 0).flatten(1).any(1).sum())
    diag_nnz = int((diag != 0).sum())
    diag32 = diag.float()
    gen = torch.Generator(device=device).manual_seed(11)
    out = {BF[k]: [] for k in BF}
    lib_label = ("one torch.sparse call on the tiles' CSR (their bf16 values "
                 "in f32) and x rounded to bf16 beforehand")

    def show(k, sh, f32):
        lib = sh["library_ms"]
        print(f"  {BF[k]} {sh['shape']}: kernel_ms={sh['ms']:.4f} (f32 form "
              f"{f32['ms']:.4f}) plain_ms={sh['plain_ms']:.4f} library_ms="
              f"{'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']}; f32 form "
              f"{f32['bound_ms']:.4f})")

    with torch.inference_mode():
        for feat in (NUM_FEATURES, HIDDEN):
            x = torch.randn((n, feat), generator=gen, device=device)
            xr = x.to(torch.bfloat16).float()
            init = torch.randn((n, feat), generator=gen, device=device)
            print(f"bf16 F={feat}:")
            slabs = uniq_cols * 128 * feat * 4
            # K1: the live tiles at 2 bytes an entry, the indices, the slabs
            # of the distinct input blocks, init and out; 2 FLOPs per tile
            # non-zero and feature
            b1, by1 = bound(tiles * 128 * 128 * 2 + (2 * tiles_all + nb + 1)
                            * 4 + slabs + 2 * n * feat * 4,
                            2.0 * nnz * feat)
            got = bsr_spmm_acc(b0, x, init)
            err = compare(f"K1bf bsr_spmm_acc F={feat}", got,
                          bsr_spmm_acc_plain(b0, x, init))
            compare(f"K1bf library torch.sparse.addmm F={feat}",
                    torch.sparse.addmm(init, a_tiles, xr), got)
            sh = dict(F=feat, shape=f"F={feat}", **err, bound_ms=b1,
                      bound_by=by1,
                      ms=cuda_ms(lambda: bsr_spmm_acc(b0, x, init), 20),
                      plain_ms=cuda_ms(lambda: bsr_spmm_acc_plain(
                          b0, x, init), 5),
                      library_ms=cuda_ms(lambda: torch.sparse.addmm(
                          init, a_tiles, xr), 20), library_label=lib_label)
            out["K1bf"].append(sh)
            show("K1", sh, f32_row(shapes, "K1", F=feat, operator=None))
            # K2, K9, K10: K1's function from zero (out written, no init)
            bw, byw = bound(tiles * 128 * 128 * 2 + (tiles + nb + 1) * 4
                            + slabs + n * feat * 4, 2.0 * nnz * feat)
            for k, (b, walk) in walks.items():
                xl = x if k == "K10" else xr     # K10 leaves x unrounded
                label = (lib_label.replace("x rounded to bf16 beforehand",
                                           "x as it is")
                         if k == "K10" else lib_label)
                got = walk(b, x)
                torch.cuda.synchronize()
                err = compare(f"{BF[k]} {walk.__name__} F={feat}", got,
                              bsr_spmm_plain(b, x))
                compare(f"{BF[k]} library torch.sparse.mm F={feat}",
                        torch.sparse.mm(a_tiles, xl), got)
                sh = dict(F=feat, shape=f"F={feat}", **err, bound_ms=bw,
                          bound_by=byw, ms=cuda_ms(lambda: walk(b, x), 20),
                          plain_ms=cuda_ms(lambda: bsr_spmm_plain(b, x), 5),
                          library_ms=cuda_ms(
                              lambda: torch.sparse.mm(a_tiles, xl), 20),
                          library_label=label)
                out[BF[k]].append(sh)
                show(k, sh, f32_row(shapes, k, F=feat))
            # K8: the live blocks at 2 bytes an entry, x, init once, out
            x3, xr3 = x.reshape(nb, 128, feat), xr.reshape(nb, 128, feat)
            i3 = init.reshape(nb, 128, feat)
            for transpose in (False, True):
                a3 = diag32.transpose(1, 2) if transpose else diag32
                for with_init in (True, False):
                    it = init if with_init else None
                    tag = (f"F={feat}{' transpose' if transpose else ''}"
                           f"{' init' if with_init else ''}")
                    got = diag_spmm(diag, x, r8, transpose, it)
                    err = compare(f"K8bf diag_spmm {tag}", got,
                                  diag_spmm_plain(diag, x, r8, transpose, it))

                    def lib8(a3=a3, with_init=with_init):
                        if with_init:
                            return torch.baddbmm(i3, a3, xr3)
                        return torch.bmm(a3, xr3)

                    compare(f"K8bf library torch.baddbmm {tag}",
                            lib8().reshape(n, feat), got)
                    b8, by8 = bound(diag_live * 128 * 128 * 2
                                    + n * feat * 4 * (3 if with_init else 2),
                                    2.0 * diag_nnz * feat)
                    sh = dict(
                        F=feat, shape=tag, transpose=transpose,
                        init=with_init,
                        on_path=with_init and (feat == HIDDEN
                                               or not transpose),
                        **err, bound_ms=b8, bound_by=by8,
                        ms=cuda_ms(lambda: diag_spmm(diag, x, r8, transpose,
                                                     it), 20),
                        plain_ms=cuda_ms(lambda: diag_spmm_plain(
                            diag, x, r8, transpose, it), 5),
                        library_ms=cuda_ms(lib8, 20),
                        library_label="torch.baddbmm / torch.bmm on the "
                                      "blocks in f32 and x rounded to bf16 "
                                      "beforehand")
                    out["K8bf"].append(sh)
                    show("K8", sh, f32_row(shapes, "K8", shape=tag))
            del x, xr, init, x3, xr3, i3, got
        out.update(_bf16_k7_rows(device, ops["gat"], shapes, gen))
    del walks, diag, diag32, a_tiles, b0
    torch.cuda.empty_cache()
    return out


def _bf16_k7_rows(device, h, shapes, gen) -> dict:
    """K7rm, K7f, K7bt's dx and K7s's pass on GAT's bf16 mask, each against
    its plain version and its f32 form on the mask widened to f32."""
    from fitgnn_tpu_torch.ops import att_bsr

    hd = h.to(device)
    b, plan = hd.bsr, hd.dyn_plan
    rows, cols, blocks = b.rows, b.cols, b.blocks
    b32 = blocks.float()
    n = b.num_row_blocks * 128
    nb = n // 128
    k_all = b.nnz_blocks
    nnz = int((blocks != 0).sum())
    uniq_cols = int(torch.unique(cols).numel())
    uniq_rows = int(torch.unique(rows).numel())
    ssrc = torch.randn(n, generator=gen, device=device)
    sdst = torch.randn(n, generator=gen, device=device)
    dden = torch.randn(n, generator=gen, device=device)
    mg = (sdst + ssrc.max()).clamp_min(0.0)
    vec = n * 4
    tile_bytes = k_all * 128 * 128 * 2
    idx_f = (k_all + nb + 1) * 4
    idx_t = (3 * plan.t_sel.numel() + nb + 1) * 4
    out = {BF[k]: [] for k in ("K7rm", "K7f", "K7bt", "K7s")}

    def show(k, sh, f32):
        print(f"  {BF[k]} F={sh['F']}: kernel_ms={sh['ms']:.4f} (f32 form "
              f"{f32['ms']:.4f}) plain_ms={sh['plain_ms']:.4f} "
              f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']}; f32 form "
              f"{f32['bound_ms']:.4f})")

    def fwd(bl):
        return (rows, cols, plan, bl, ssrc, sdst)

    def same(name, got, f32):
        check(all(torch.equal(a, c) for a, c in zip(got, f32)),
              f"{name}: the bf16 form differs from the f32 form")

    with torch.inference_mode():
        rm = att_bsr.att_rowmax(*fwd(blocks), SLOPE)
        rp = att_bsr.att_rowmax_plain(*fwd(blocks), SLOPE)
        same("K7rmbf", (rm,), (att_bsr.att_rowmax(*fwd(b32), SLOPE),))
        has = rp > -1e29
        check(torch.equal(rm <= -1e29, ~has), "K7rmbf: rows without a tile "
              "entry differ from the plain version")
        err = compare("K7rmbf att_rowmax", rm[has], rp[has])
        brm, byrm = bound(tile_bytes + idx_f + 3 * vec, 3.0 * nnz)
        sh = dict(F=None, shape="rows", **err, bound_ms=brm, bound_by=byrm,
                  ms=cuda_ms(lambda: att_bsr.att_rowmax(*fwd(blocks), SLOPE),
                             20),
                  plain_ms=cuda_ms(lambda: att_bsr.att_rowmax_plain(
                      *fwd(blocks), SLOPE), 5), library_ms=None)
        out["K7rmbf"].append(sh)
        show("K7rm", sh, f32_row(shapes, "K7rm", F=None))
        for feat in (NUM_FEATURES, HIDDEN):
            x = torch.randn((n, feat), generator=gen, device=device)
            gr = torch.randn((n, feat), generator=gen, device=device)

            def bwd(bl):
                return (plan, bl, ssrc, sdst, mg, gr, x, dden, SLOPE)

            def dx_walk(bl):
                return att_bsr._launch_walk(
                    "att_bwd_t (dx)", device, bl, plan.t_row_splits,
                    plan.t_sel, plan.t_scale, plan.t_cols, None, ssrc, sdst,
                    mg, gr, None, True, SLOPE)

            def scores(bl):
                return att_bsr._launch_scores(
                    "att_bwd_scores", device, bl, rows, cols, None, ssrc,
                    sdst, mg, gr, x, dden, SLOPE)

            num, den = att_bsr.att_fwd(*fwd(blocks), mg, x, SLOPE)
            same(f"K7fbf F={feat}", (num, den),
                 att_bsr.att_fwd(*fwd(b32), mg, x, SLOPE))
            num_p, den_p = att_bsr.att_fwd_plain(*fwd(blocks), mg, x, SLOPE)
            e_f = [compare(f"K7fbf att_fwd {w} F={feat}", a, p_)
                   for w, a, p_ in (("num", num, num_p), ("den", den, den_p))]
            dx = dx_walk(blocks)
            same(f"K7btbf F={feat}", (dx,), (dx_walk(b32),))
            e_t = compare(f"K7btbf att_bwd_t dx F={feat}", dx,
                          att_bsr.att_bwd_t_plain(*bwd(blocks),
                                                  need_dssrc=False)[0])
            part = scores(blocks)
            same(f"K7sbf F={feat}", part, scores(b32))
            part_p = att_bsr.att_scores_plain(rows, cols, *bwd(blocks))
            e_s = [compare(f"K7sbf pass {w} partials F={feat}", a, p_)
                   for w, a, p_ in zip(("column", "row"), part, part_p)]
            del num, den, num_p, den_p, dx, part, part_p
            slabs = 128 * feat * 4
            # the f32 rows' bounds (phase 3) with the tiles at 2 bytes
            bf, byf = bound(tile_bytes + idx_f + 3 * vec + uniq_cols * slabs
                            + n * feat * 4 + vec, nnz * (2.0 * feat + 5))
            bdx, bydx = bound(tile_bytes + idx_t + 3 * vec
                              + uniq_rows * slabs + n * feat * 4,
                              nnz * (2.0 * feat + 5))
            bs, bys = bound(tile_bytes + 2 * k_all * 4 + 4 * vec
                            + (uniq_rows + uniq_cols) * slabs
                            + 2 * k_all * 128 * 4, nnz * (2.0 * feat + 8))
            rows_ = (
                ("K7f", e_f, bf, byf, True,
                 lambda: att_bsr.att_fwd(*fwd(blocks), mg, x, SLOPE),
                 lambda: att_bsr.att_fwd_plain(*fwd(blocks), mg, x, SLOPE)),
                ("K7bt", [e_t], bdx, bydx, feat == HIDDEN,
                 lambda: dx_walk(blocks),
                 lambda: att_bsr.att_bwd_t_plain(*bwd(blocks),
                                                 need_dssrc=False)),
                ("K7s", e_s, bs, bys, True, lambda: scores(blocks),
                 lambda: att_bsr.att_scores_plain(rows, cols,
                                                  *bwd(blocks))))
            for k, errs, bd, by, on_path, kernel, plain in rows_:
                sh = dict(F=feat, shape=f"F={feat}", on_path=on_path,
                          max_abs_err=max(e["max_abs_err"] for e in errs),
                          max_rel_err=max(e["max_rel_err"] for e in errs),
                          bound_ms=bd, bound_by=by, ms=cuda_ms(kernel, 20),
                          plain_ms=cuda_ms(plain, 5), library_ms=None)
                out[BF[k]].append(sh)
                show(k, sh, f32_row(shapes, k, F=feat))
            del x, gr
    print("K7 bf16 forms: bit for bit their f32 forms on the same mask")
    del hd, b32
    torch.cuda.empty_cache()
    return out


def phase_bf16_edge_cases(device, ops) -> None:
    """The walk's edge cases on the bench graph's bf16 operators at F=512:
    a NaN tile entry reaches its own output row and no other (K1, K2, K9,
    K10; K8 forward and transposed from init), the other rows within the
    tolerance of the plain version; an inf in x (K7f) or g (K7bt's dx) at
    a row that only masked-out entries reach leaves the output finite, equal
    to the plain version's with that row zeroed."""
    from fitgnn_tpu_torch.ops import att_bsr
    from fitgnn_tpu_torch.ops.bsr_spmm import (bsr_spmm_acc,
                                               bsr_spmm_acc_plain,
                                               bsr_spmm_fwd,
                                               bsr_spmm_grouped,
                                               bsr_spmm_plain,
                                               bsr_spmm_rowwalk)
    from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm, diag_spmm_plain

    gen = torch.Generator(device=device).manual_seed(12)

    def nan_case(what, run, plain, blocks, tile, row):
        bl = blocks.clone()
        bl[tile, 20, 30] = float("nan")
        got, ref = run(bl), plain(bl)
        torch.cuda.synchronize()
        rows_nan = got.isnan().any(1).nonzero().flatten().tolist()
        check(rows_nan == [row] and bool(got[row].isnan().all()),
              f"{what} nan: NaN rows {rows_nan[:4]}, expected [{row}]")
        keep = ~ref.isnan().any(1)
        compare(f"{what} nan: rows the NaN does not reach", got[keep],
                ref[keep])

    with torch.inference_mode():
        n = ops["default"].num_nodes
        x = torch.randn((n, HIDDEN), generator=gen, device=device)
        init = torch.randn((n, HIDDEN), generator=gen, device=device)
        for k, name, walk in (("K1bf", "default", None),
                              ("K2bf", "default", bsr_spmm_fwd),
                              ("K9bf", "group2", bsr_spmm_grouped),
                              ("K10bf", "rowwalk", bsr_spmm_rowwalk)):
            b = ops[name].bsr.to(device)
            tile = int((b.blocks != 0).flatten(1).any(1).nonzero()[0])

            def with_(bl, b=b):
                return dataclasses.replace(b, blocks=bl)

            if walk is None:
                run = lambda bl: bsr_spmm_acc(with_(bl), x, init)  # noqa
                plain = lambda bl: bsr_spmm_acc_plain(with_(bl), x, init)  # noqa
            else:
                run = lambda bl, w=walk: w(with_(bl), x)  # noqa
                plain = lambda bl: bsr_spmm_plain(with_(bl), x)  # noqa
            nan_case(k, run, plain, b.blocks, tile,
                     int(b.rows[tile]) * 128 + 20)
        diag, r8 = ops["diag"].diag_blocks.to(device), ops["diag"].diag_r
        blk = int((diag != 0).flatten(1).any(1).nonzero()[0])
        for transpose in (False, True):
            nan_case(f"K8bf{'T' if transpose else ''} init",
                     lambda bl: diag_spmm(bl, x, r8, transpose, init),
                     lambda bl: diag_spmm_plain(bl, x, r8, transpose, init),
                     diag, blk, blk * 128 + (30 if transpose else 20))
        h = ops["gat"].to(device)
        b, plan = h.bsr, h.dyn_plan
        ssrc = torch.randn(n, generator=gen, device=device)
        sdst = torch.randn(n, generator=gen, device=device)
        dden = torch.randn(n, generator=gen, device=device)
        mg = (sdst + ssrc.max()).clamp_min(0.0)
        g = torch.randn((n, HIDDEN), generator=gen, device=device)
        for k in ("K7fbf", "K7btbf"):
            # K7f: node 50 of the first tile's column block reaches no
            # output once its column is cleared in every tile of that block
            # column; K7bt: node 50 of its row block, its row cleared
            fwd = k == "K7fbf"
            blk = int((b.cols if fwd else b.rows)[0])
            bl = b.blocks.clone()
            sel = (b.cols if fwd else b.rows) == blk
            if fwd:
                bl[sel, :, 50] = 0
            else:
                bl[sel, 50, :] = 0
            node = blk * 128 + 50
            v = (x if fwd else g).clone()
            v[node] = float("inf")
            clean = v.clone()
            clean[node] = 0.0
            if fwd:
                def run(fn, vv):
                    num, den = fn(b.rows, b.cols, plan, bl, ssrc, sdst, mg,
                                  vv, SLOPE)
                    return torch.cat([num, den[:, None]], 1)
                kernel, plain = att_bsr.att_fwd, att_bsr.att_fwd_plain
            else:
                def run(fn, vv):
                    return fn(plan, bl, ssrc, sdst, mg, vv, x, dden, SLOPE,
                              need_dssrc=False)[0]
                kernel, plain = att_bsr.att_bwd_t, att_bsr.att_bwd_t_plain
            got = run(kernel, v)
            torch.cuda.synchronize()
            check(bool(run(plain, v).isnan().any()),
                  f"{k} inf_unreached: the dense product gives no NaN")
            compare(f"{k} inf_unreached vs plain on the row zeroed", got,
                    run(plain, clean))
    del x, init, g, h, diag
    torch.cuda.empty_cache()
    print("bf16 edge cases: NaN entries reach their own rows only; infs "
          "that only masked-out entries reach stay out")


# launches of one GCN step and eval forward (dropout off) on each bf16
# operator, before the tile kernels take their bf16 forms.  Kernels and
# plain versions sum in another order, so an input of a layer may round to
# the other bf16 neighbour in one of them: on the bench graph that moves
# the steps by ~4e-5·max|ref| (H100, PERF.md §6), inside the tolerance
BF16_STEP = {"default": STEP["GCNConv"], "diag": {"K3": 3, "K8": 3, "K1": 3},
             "group2": {"K3": 3, "K9": 3}, "rowwalk": {"K3": 3, "K10": 3}}
BF16_EVAL = {"default": EVAL["GCNConv"], **OPTIN_EVAL}


def phase_bf16_steps(device, g, ops) -> dict:
    """Through the library surface, every counter at 0 just before each
    counted run: one GCN training step (hidden 512, dropout off) and one
    eval forward on each bf16 operator (default: K1; ``use_diag``: K8 and
    K1; ``tile_group=2``: K9; ``use_rowwalk``: K10; K3 on each) with the
    kernels, held against the same step with the plain versions; two eval
    forwards on the forward-only bf16 operator (K2), against the default
    bf16 operator's; one GAT step and eval forward under ``FUSED`` and
    under ``FUSED_EXACT`` on the bf16 mask, against the plain versions and
    the step against the same step on the mask in f32 (K7's forms are bit for bit
    their f32 forms there)."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.train.losses import masked_nll

    phases = {}

    def run(layer, gd, env, want, what):
        model = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                          dropout_rate=0.0)
        model = model.reset_parameters(torch.Generator().manual_seed(0)).to(
            device)

        def step():
            model.zero_grad(set_to_none=True)
            model.train()
            loss = masked_nll(model(gd.x, gd), gd.y, gd.train_mask)
            loss.backward()
            model.eval()
            with torch.inference_mode():
                fwd = model(gd.x, gd)
            torch.cuda.synchronize()
            return loss.detach(), {k: p.grad.detach().clone()
                                   for k, p in model.named_parameters()}, fwd

        with switches(env):
            reset_counts()
            got = step()
            launches = read_counts()
            expect(launches, want, what)
            phases[what] = launches
            with plain_versions():
                ref = step()
        compare(f"{what} loss kernels vs plain", got[0].reshape(1),
                ref[0].reshape(1))
        for k in ref[1]:
            compare(f"{what} grad {k} kernels vs plain", got[1][k],
                    ref[1][k])
        compare(f"{what} eval forward kernels vs plain", got[2], ref[2])
        del model
        return got

    for name in ("default", "diag", "group2", "rowwalk"):
        gd = g._replace(aux=ops[name]).to(device)
        want = {k: BF16_STEP[name].get(k, 0) + BF16_EVAL[name].get(k, 0)
                for k in (*BF16_STEP[name], *BF16_EVAL[name])}
        out = run("GCNConv", gd, {}, bf16_counts(want),
                  f"bf16 gcn512 {name} step and eval")[2]
        if name == "default":
            ref_fwd = out
            fwd_only = gd._replace(aux=dataclasses.replace(
                gd.aux, bsr=dataclasses.replace(gd.aux.bsr, transpose=None)))
            model = NodeModel("GCNConv", NUM_FEATURES, HIDDEN, 2,
                              NUM_CLASSES).reset_parameters(
                torch.Generator().manual_seed(0)).to(device).eval()
            with torch.inference_mode():
                reset_counts()
                outs = [model(fwd_only.x, fwd_only) for _ in range(2)]
                torch.cuda.synchronize()
                launches = read_counts()
            expect(launches, {"K3": 4, "K2bf": 4},
                   "bf16 serve gcn512 forward-only")
            phases["bf16 serve gcn512 forward-only"] = launches
            compare("bf16 forward-only operator vs the default bf16 "
                    "operator", outs[0], ref_fwd)
            del model, outs, fwd_only
        del gd
        torch.cuda.empty_cache()
    h = ops["gat"]
    h32 = dataclasses.replace(h, bsr=dataclasses.replace(
        h.bsr, blocks=h.bsr.blocks.float(), transpose=dataclasses.replace(
            h.bsr.transpose, blocks=h.bsr.transpose.blocks.float())))
    for mode in ("GATConv fused", "GATConv fused exact"):
        gd = g._replace(aux=h).to(device)
        want = {k: STEP[mode].get(k, 0) + EVAL[mode].get(k, 0)
                for k in (*STEP[mode], *EVAL[mode])}
        loss, grads, fwd = run("GATConv", gd, MODE_ENV[mode],
                               bf16_counts(want),
                               f"bf16 {mode} step and eval")
        gd = g._replace(aux=h32).to(device)
        with switches(MODE_ENV[mode]):
            model = NodeModel("GATConv", NUM_FEATURES, HIDDEN, 2,
                              NUM_CLASSES, dropout_rate=0.0)
            model = model.reset_parameters(
                torch.Generator().manual_seed(0)).to(device).train()
            loss32 = masked_nll(model(gd.x, gd), gd.y, gd.train_mask)
            loss32.backward()
        compare(f"bf16 {mode} loss vs the f32 mask", loss.reshape(1),
                loss32.detach().reshape(1))
        for k, p in model.named_parameters():
            compare(f"bf16 {mode} grad {k} vs the f32 mask", grads[k],
                    p.grad)
        del gd, model, grads, fwd
        torch.cuda.empty_cache()
    return phases


# ---- phase 26: bf16 activations (the conv stack's dtype=torch.bfloat16) ---

BF16_ACT_RTOL = 2 ** -6


def compare_bf16(name: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    """``compare`` for bf16 outputs of the same rule: f32 sums taken in
    another order, each rounded to bf16 once, may round to neighbouring
    bf16 values: rtol 2⁻⁶ (two bf16 steps where a step is largest, 2⁻⁷ of
    the value) and atol 1e-4·max|ref|."""
    check(got.dtype == ref.dtype == torch.bfloat16,
          f"{name}: {got.dtype} / {ref.dtype}, not bf16")
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    atol = 1e-4 * float(ref.abs().max())
    max_abs = float(diff.max())
    max_rel = float((diff / ref.abs().clamp_min(max(atol, 1e-30))).max())
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(atol={atol:.3e}, rtol={BF16_ACT_RTOL})")
    check(bool((diff <= atol + BF16_ACT_RTOL * ref.abs()).all()),
          f"{name}: kernel disagrees with its plain version")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel}


def _library_bf16(fn):
    """``fn``'s time (a torch.sparse call on bf16 operands), or None where
    the card's PyTorch has no such product; the reason printed."""
    try:
        fn()
    except (RuntimeError, NotImplementedError) as exc:
        print(f"  library call on bf16 refused: {str(exc).splitlines()[0]}")
        return None
    return cuda_ms(fn, 20)


def phase_bf16_act_kernels(device, g, ops) -> dict:
    """The kernels' bf16-activation forms at F=128 and 512 on the bench
    graph, each against its plain version (``compare_bf16``; K11a bit for
    bit), with kernel, plain and library times, the f32-activation form's
    time on the same operator beside it, and the bound from the bytes it
    moves (activations at 2 bytes a value) and its operations: K1a (phase
    3's f32 tiles) and K1bfa (bench.py's bf16 tiles, phase 11's default
    operator) on ``bsr`` and ``bsr.transpose``; K3a on the GCN straggler CSR
    both ways, K3wa (K3w) and K6a (K6) on GAT's with runtime weights (K3wa
    also on the transpose CSR with the permutation); K11a at (N_pad, 512).
    Then each widened form once against its plain version
    (``phase_bf16_act_widened``)."""
    from fitgnn_tpu_torch.ops.bsr_spmm import bsr_spmm_acc, bsr_spmm_acc_plain
    from fitgnn_tpu_torch.ops.coo_segmm import (
        segmm_spmm, segmm_spmm_plain, segmm_weighted_den_raw,
        segmm_weighted_den_raw_plain, segmm_weighted_raw,
        segmm_weighted_raw_plain)
    from fitgnn_tpu_torch.ops.dropout import (philox_dropout,
                                              philox_dropout_plain,
                                              seed_from_generator)

    bf16 = torch.bfloat16
    n = g.num_nodes_padded
    nb = n // 128
    h32, hbf = g.aux.to(device), ops["default"].to(device)
    hgat = ops["gat"].to(device)
    gen = torch.Generator(device=device).manual_seed(26)
    out = {k: [] for k in ("K1a", "K1bfa", "K3a", "K3wa", "K6a", "K11a")}

    def show(k, sh):
        lib = sh["library_ms"]
        print(f"  {k} {sh['shape']}: kernel_ms={sh['ms']:.4f} (f32 "
              f"activations {sh['f32_ms']:.4f}) plain_ms="
              f"{sh['plain_ms']:.4f} library_ms="
              f"{'null' if lib is None else f'{lib:.4f}'} bound_ms="
              f"{sh['bound_ms']:.4f} ({sh['bound_by']})"
              + (f" wrapper_ms={sh['wrapper_ms']:.4f}"
                 if "wrapper_ms" in sh else ""))

    with torch.inference_mode():
        for feat in (NUM_FEATURES, HIDDEN):
            x32 = torch.randn((n, feat), generator=gen, device=device)
            init32 = torch.randn((n, feat), generator=gen, device=device)
            x, init = x32.to(bf16), init32.to(bf16)
            print(f"bf16 activations F={feat}:")
            # K1a / K1bfa, forward and transpose
            for k, h, tile_bytes in (("K1a", h32, 4), ("K1bfa", hbf, 2)):
                for way, b in (("forward", h.bsr),
                               ("transpose", h.bsr.transpose)):
                    nz_tile = (b.blocks != 0).flatten(1).any(1)
                    tiles = int(nz_tile.sum())
                    nnz = int((b.blocks != 0).sum())
                    uniq = int(torch.unique(b.cols[nz_tile]).numel())
                    tag = f"F={feat} {way}"
                    got = bsr_spmm_acc(b, x, init)
                    again = bsr_spmm_acc(b, x, init)
                    err = compare_bf16(f"{k} bsr_spmm_acc {tag}", got,
                                       bsr_spmm_acc_plain(b, x, init))
                    check(torch.equal(got, again),
                          f"{k} {tag}: two launches differ")
                    try:
                        a_csr = tile_csr(b, n)[0].to(bf16)
                    except (RuntimeError, NotImplementedError) as exc:
                        a_csr = None
                        print("  bf16 CSR refused: "
                              f"{str(exc).splitlines()[0]}")
                    b1, by1 = bound(
                        tiles * 128 * 128 * tile_bytes
                        + (2 * b.nnz_blocks + nb + 1) * 4
                        + uniq * 128 * feat * 2 + 2 * n * feat * 2,
                        2.0 * nnz * feat)
                    sh = dict(
                        F=feat, shape=tag, on_path=feat == HIDDEN, **err,
                        bound_ms=b1, bound_by=by1,
                        ms=cuda_ms(lambda: bsr_spmm_acc(b, x, init), 20),
                        f32_ms=cuda_ms(lambda: bsr_spmm_acc(b, x32, init32),
                                       20),
                        plain_ms=cuda_ms(
                            lambda: bsr_spmm_acc_plain(b, x, init), 5),
                        library_ms=None if a_csr is None else _library_bf16(
                            lambda: torch.sparse.addmm(init, a_csr, x)),
                        library_label="torch.sparse.addmm on the tiles' "
                                      "CSR in bf16 and bf16 x, init")
                    out[k].append(sh)
                    show(k, sh)
                    del a_csr, got, again
            # K3a on the GCN stragglers, both ways
            for way, m in (("forward", h32.segmm),
                           ("transpose", h32.t_segmm)):
                tag = f"F={feat} {way}"
                live = m.weights != 0
                e = int(live.sum())
                uniq = int(torch.unique(m.senders[live]).numel())
                got = segmm_spmm(m, x)
                check(torch.equal(got, segmm_spmm(m, x)),
                      f"K3a {tag}: two launches differ")
                err = compare_bf16(f"K3a segmm_spmm {tag}", got,
                                   segmm_spmm_plain(m, x))
                a_str = torch.sparse_csr_tensor(m.row_ptr, m.senders,
                                                m.weights.to(bf16), (n, n))
                b3, by3 = bound((n + 1) * 4 + e * 8 + uniq * feat * 2
                                + n * feat * 2, 2.0 * e * feat)
                sh = dict(F=feat, shape=tag, on_path=feat == HIDDEN, **err,
                          bound_ms=b3, bound_by=by3,
                          **segmm_times(lambda: segmm_spmm(m, x)),
                          f32_ms=device_ms(lambda: segmm_spmm(m, x32), 20),
                          plain_ms=cuda_ms(lambda: segmm_spmm_plain(m, x),
                                           5),
                          library_ms=_library_bf16(
                              lambda: torch.sparse.mm(a_str, x)),
                          library_label="torch.sparse.mm on the straggler "
                                        "CSR in bf16 and bf16 x")
                out["K3a"].append(sh)
                show("K3a", sh)
            # K3wa and K6a on GAT's stragglers with runtime weights
            m, mt = hgat.segmm, hgat.t_segmm
            live = m.weights != 0
            e = int(live.sum())
            uniq = int(torch.unique(m.senders[live]).numel())
            w_edge = torch.rand(m.senders.shape, generator=gen,
                                device=device)
            perm = hgat.t_edge_perm
            for k, tag, fn, plain, extra, path in (
                    ("K3wa", f"F={feat} forward",
                     lambda: segmm_weighted_raw(m, w_edge, x),
                     lambda: segmm_weighted_raw_plain(m, w_edge, x),
                     e * 4, False),
                    ("K3wa", f"F={feat} transpose",
                     lambda: segmm_weighted_raw(mt, w_edge, x, perm),
                     lambda: segmm_weighted_raw_plain(mt, w_edge, x, perm),
                     e * 8, feat == HIDDEN),
                    ("K6a", f"F={feat} forward",
                     lambda: segmm_weighted_den_raw(m, w_edge, x),
                     lambda: segmm_weighted_den_raw_plain(m, w_edge, x),
                     e * 4 + n * 4, True)):
                got, ref = fn(), plain()
                again = fn()
                if k == "K6a":
                    check(torch.equal(got[1], again[1]),
                          f"K6a {tag}: two launches' den differ")
                    compare(f"K6a den {tag}", got[1], ref[1])
                    got, ref, again = got[0], ref[0], again[0]
                check(torch.equal(got, again),
                      f"{k} {tag}: two launches differ")
                err = compare_bf16(f"{k} {tag}", got, ref)
                bw, byw = bound((n + 1) * 4 + e * 8 + extra
                                + uniq * feat * 2 + n * feat * 2,
                                2.0 * e * feat + e)
                wide = {"K3wa": lambda: segmm_weighted_raw(m, w_edge, x32),
                        "K6a": lambda: segmm_weighted_den_raw(
                            m, w_edge, x32)}[k]
                sh = dict(F=feat, shape=tag, on_path=path, **err,
                          bound_ms=bw, bound_by=byw, **segmm_times(fn),
                          f32_ms=device_ms(wide, 20),
                          plain_ms=cuda_ms(plain, 5), library_ms=None,
                          library_label="none: no one-call PyTorch product "
                                        "forms w_edge·weights per edge")
                out[k].append(sh)
                show(k, sh)
            del x, init, x32, init32, got, ref, again, w_edge
        # K11a at the layer output's shape, bit for bit
        x32 = torch.randn((n, HIDDEN), generator=gen, device=device)
        x = x32.to(bf16)
        seed = seed_from_generator(gen, device)
        got = philox_dropout(x, seed, 0.5)
        check(torch.equal(got, philox_dropout_plain(x, seed, 0.5)),
              "K11a: kernel and plain version differ")
        check(torch.equal(got == 0, philox_dropout(x32, seed, 0.5) == 0),
              "K11a: its mask is not the f32 form's")
        print(f"K11a philox_dropout on bf16: bit-exact, the f32 form's mask "
              f"on {x.numel()} values")
        b11, by11 = bound(2 * x.numel() * 2 + 4, float(x.numel()))
        sh = dict(F=HIDDEN, shape=f"({n}, {HIDDEN})", max_abs_err=0.0,
                  max_rel_err=0.0, bit_exact=True, bound_ms=b11,
                  bound_by=by11,
                  ms=cuda_ms(lambda: philox_dropout(x, seed, 0.5), 20),
                  f32_ms=cuda_ms(lambda: philox_dropout(x32, seed, 0.5), 20),
                  plain_ms=cuda_ms(lambda: philox_dropout_plain(x, seed, 0.5),
                                   3),
                  library_ms=cuda_ms(lambda: torch.nn.functional.dropout(
                      x, 0.5, training=True), 20),
                  library_label="torch.nn.functional.dropout on bf16 (its "
                                "own mask stream)")
        out["K11a"].append(sh)
        show("K11a", sh)
        del x, x32, got
        phase_bf16_act_widened(device, g, ops, gen)
    del h32, hbf, hgat
    torch.cuda.empty_cache()
    return out


def phase_bf16_act_widened(device, g, ops, gen) -> None:
    """Each form without a bf16-activation form, once on bf16 operands of
    the bench graph at F=512: the launch counted as its f32 form's, its
    output the f32 form on the widened operands rounded once (bit for bit)
    and the plain version's within ``compare_bf16``: K2 (forward-only),
    K9, K10, K8 (transposed, from init), K7f, K7bt's ``dx`` and K7s on
    GAT's mask, and K1 at edge 256 (a synthetic community graph: the
    quadrant walk with words).  K4, K4ᵀ and K5 have bf16-activation forms
    of their own (phase 27)."""
    from fitgnn_tpu_torch.ops import att_bsr
    from fitgnn_tpu_torch.ops.bsr_spmm import (build_bsr, bsr_spmm_acc,
                                               bsr_spmm_acc_plain,
                                               bsr_spmm_fwd,
                                               bsr_spmm_grouped,
                                               bsr_spmm_plain,
                                               bsr_spmm_rowwalk)
    from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm, diag_spmm_plain

    bf16 = torch.bfloat16
    n = g.num_nodes_padded
    x = torch.randn((n, HIDDEN), generator=gen, device=device).to(bf16)
    init = torch.randn((n, HIDDEN), generator=gen, device=device).to(bf16)
    b2 = ops["default"].bsr.to(device)
    b9 = ops["group2"].bsr.to(device)
    b10 = ops["rowwalk"].bsr.to(device)
    hd = ops["diag"]
    diag = hd.diag_blocks.to(device)
    hg = ops["gat"].to(device)
    bg, plan = hg.bsr, hg.dyn_plan
    rows, cols = bg.rows, bg.cols
    ssrc = torch.randn(n, generator=gen, device=device)
    sdst = torch.randn(n, generator=gen, device=device)
    m = att_bsr.att_rowmax(rows, cols, plan, bg.blocks, ssrc, sdst, SLOPE)
    m = torch.where(m > -1e29, m + 1.0, m)
    dden = torch.randn(n, generator=gen, device=device)
    rng = np.random.default_rng(26)
    n2 = 16384
    r2 = np.sort(rng.integers(0, n2, 200_000))
    s2 = np.where(rng.random(len(r2)) < 0.85,
                  (r2 // 256) * 256 + rng.integers(0, 256, len(r2)),
                  rng.integers(0, n2, len(r2)))
    b256 = build_bsr(s2, r2, rng.random(len(r2)).astype(np.float32), n2,
                     block=256).to(device)
    check(b256.quad_bits is not None, "K1@256: no occupancy words")
    x2 = x[:n2].contiguous()
    i2 = init[:n2].contiguous()
    forms = (
        ("K2", bsr_spmm_fwd, lambda a: bsr_spmm_fwd(b2, a),
         lambda a: bsr_spmm_plain(b2, a), (x,)),
        ("K9", bsr_spmm_grouped, lambda a: bsr_spmm_grouped(b9, a),
         lambda a: bsr_spmm_plain(b9, a), (x,)),
        ("K10", bsr_spmm_rowwalk, lambda a: bsr_spmm_rowwalk(b10, a),
         lambda a: bsr_spmm_plain(b10, a), (x,)),
        ("K8", diag_spmm,
         lambda a, c: diag_spmm(diag, a, hd.diag_r, True, c),
         lambda a, c: diag_spmm_plain(diag, a, hd.diag_r, True, c),
         (x, init)),
        ("K7f", att_bsr.att_fwd,
         lambda a: att_bsr.att_fwd(rows, cols, plan, bg.blocks, ssrc, sdst,
                                   m, a, SLOPE)[0],
         lambda a: att_bsr.att_fwd_plain(rows, cols, plan, bg.blocks, ssrc,
                                         sdst, m, a, SLOPE)[0], (x,)),
        ("K7bt", att_bsr.att_bwd_t,
         lambda a, c: att_bsr.att_bwd_t(plan, bg.blocks, ssrc, sdst, m, a, c,
                                        dden, SLOPE, need_dssrc=False)[0],
         lambda a, c: att_bsr.att_bwd_t_plain(plan, bg.blocks, ssrc, sdst, m,
                                              a, c, dden, SLOPE,
                                              need_dssrc=False)[0],
         (init, x)),
        ("K7s", att_bsr.att_bwd_scores,
         lambda a, c: att_bsr.att_bwd_scores(rows, cols, plan, bg.blocks,
                                             ssrc, sdst, m, a, c, dden,
                                             SLOPE)[1],
         lambda a, c: att_bsr.att_bwd_scores_plain(rows, cols, plan,
                                                   bg.blocks, ssrc, sdst, m,
                                                   a, c, dden, SLOPE)[1],
         (init, x)),
        ("K1@256", bsr_spmm_acc, lambda a, c: bsr_spmm_acc(b256, a, c),
         lambda a, c: bsr_spmm_acc_plain(b256, a, c), (x2, i2)))
    def total(fn):
        return fn.launches + getattr(fn, "launches_bf16", 0)

    print("bf16 activations, the widened route (F=512):")
    for name, fn, call, plain, acts in forms:
        before = total(fn)
        got = call(*acts)
        check(total(fn) == before + 1,
              f"{name}: the widened route launched no f32 form")
        check(torch.equal(got, call(*(a.float() for a in acts)).to(
            got.dtype)), f"{name}: not the f32 form on widened operands")
        ref = plain(*acts)
        if got.dtype == bf16:
            compare_bf16(f"{name} widened", got, ref)
        else:
            compare(f"{name} widened", got, ref)
    del x, init, b2, b9, b10, diag, hg, b256, x2, i2


def phase_bf16_act_steps(device, g, ops) -> dict:
    """The bf16 stack through the library surface at hidden 512, each step
    beside its f32 twin (the same model without ``dtype``) in the same
    call, every counter at 0 just before each counted run:

    * bench.py's configuration: a bf16 GCN stack on bench.py's bf16 tiles,
      layer 0 pre-aggregated (``preaggregate_input``, then bf16), bit
      dropout 0.5: one ``gc_train_step`` and one eval forward launch K3a
      and K1bfa (3 each) and no f32 form of K1 or K3;
    * the bf16 GCN + K11 step (``fused_dropout=True, bit_dropout=False``)
      on phase 3's f32 tiles: layer 0 aggregates the f32 input (K3, K1),
      layer 1 bf16 (K3a, K1a), K11a after each layer;
    * the bf16 fused + K6 GAT step (``FUSED_TILES=1 SEGMM_DEN=1``) on
      phase 11's bf16 mask: K6a, K3wa and K7's widened forms (their
      bf16-mask forms, bit for bit the f32 forms on a 0/1 mask).

    Each counted run is held against the same run with the plain versions
    (the loss within 1e-2 relative, each gradient within 5e-2·max|ref|,
    the eval forward within 2e-2·max(1, max|ref|): bf16 roundings flip on
    sums taken in another order), its eval forward printed beside the f32
    twin's, and the step and eval forward timed (CUDA events over
    ``EDGE_TIMED_STEPS``) for both."""
    from fitgnn_tpu_torch.models.models import NodeModel, preaggregate_input
    from fitgnn_tpu_torch.train import steps

    bf16 = torch.bfloat16
    phases, times = {}, {}
    gb = g._replace(aux=ops["default"]).to(device)
    x_pre = preaggregate_input(gb, "GCNConv")
    runs = (
        ("bench", "GCNConv", g._replace(aux=ops["default"]),
         dict(first_layer_preaggregated=True), {}, x_pre,
         {"K3a": 3, "K1bfa": 3}),
        ("gcn k11", "GCNConv", g, dict(fused_dropout=True,
                                       bit_dropout=False), {}, None,
         {"K3": 2, "K1": 2, "K3a": 3, "K1a": 3, "K11a": 4}),
        ("gat fused den", "GATConv", g._replace(aux=ops["gat"]), {}, FUSED,
         None, {"K7fbf": 4, "K7btbf": 1, "K7sbf": 2, "K7sums": 2, "K6a": 4,
                "K3wa": 1}))
    del gb
    for what, layer, gr, kw, env, xin, want in runs:
        gd = gr.to(device)
        gd32 = gd if xin is None else gd._replace(x=xin)
        gd16 = gd if xin is None else gd._replace(x=xin.to(bf16))

        def make(dtype):
            mdl = NodeModel(layer, gd32.x.shape[1], HIDDEN, 2, NUM_CLASSES,
                            dropout_rate=0.5, dtype=dtype, **kw)
            return mdl.reset_parameters(
                torch.Generator().manual_seed(0)).to(device)

        with switches(env):
            model = make(bf16)
            reset_counts()
            fwd, loss, grads = eval_and_step(model, gd16, device)
            launches = read_counts()
            expect(launches, want, f"bf16a {what} step and eval")
            phases[f"bf16a {what} step and eval"] = launches
            with plain_versions():
                fwd_p, loss_p, grads_p = eval_and_step(make(bf16), gd16,
                                                       device)
            check(abs(float(loss) - float(loss_p))
                  <= 1e-2 * abs(float(loss_p)),
                  f"bf16a {what}: loss {float(loss)} against the plain "
                  f"versions' {float(loss_p)}")
            for k, v in grads_p.items():
                err = float((grads[k] - v).abs().max())
                check(grads[k].dtype == torch.float32
                      and err <= 5e-2 * float(v.abs().max()),
                      f"bf16a {what}: grad {k} off the plain versions' by "
                      f"{err:.3e}")
            scale = max(1.0, float(fwd_p.abs().max()))
            err = float((fwd - fwd_p).abs().max())
            check(err <= 2e-2 * scale, f"bf16a {what}: eval forward off "
                  f"the plain versions' by {err:.3e}")
            fwd32 = eval_and_step(make(None), gd32, device)[0]
            print(f"bf16a {what}: loss {float(loss):.5f} (plain "
                  f"{float(loss_p):.5f}); eval log-probs max |bf16 - f32 "
                  f"twin| {float((fwd - fwd32).abs().max()):.4f} of "
                  f"{float(fwd32.abs().max()):.4f}")
            for name, dtype, gdx in (("bf16", bf16, gd16), ("f32", None,
                                                           gd32)):
                model = make(dtype)
                opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
                gen = torch.Generator(device=device).manual_seed(0)
                step = cuda_ms(lambda: steps.gc_train_step(
                    model, opt, gdx, gdx.y, gdx.train_mask, gen,
                    "classification"), EDGE_TIMED_STEPS)
                model.eval()
                with torch.inference_mode():
                    ev = cuda_ms(lambda: model(gdx.x, gdx), EDGE_TIMED_STEPS)
                times[f"{what} {name}"] = (step, ev)
        del gd, gd32, gd16, model, fwd, fwd_p, fwd32, grads, grads_p
        torch.cuda.empty_cache()
    print(f"bf16a ms (hidden 512, dropout 0.5, CUDA events over "
          f"{EDGE_TIMED_STEPS}; step / eval forward): "
          + ", ".join(f"{k} {s:.3f} / {e:.3f}" for k, (s, e)
                      in times.items()))
    return phases


# (out_dir, mode, the f32 run of phase 6 or 10 with the same epochs and
# seed: its index among that layer's hidden-512 rows, and how far the bf16
# run's best loss may sit from it: GAT's mask is exact in bf16, GCN's and
# SAGE's x is rounded to bf16 in K1)
BF16_CLI = (("gcn512bf16", "GCNConv", 0, 2e-2),
            ("sage512bf16", "SAGEConv", 0, 2e-2),
            ("gat512fusedbf16", "GATConv fused", 1, 1e-3))
BF16_EPOCHS = 2


def phase_bf16_cli(tmp) -> dict:
    """Through the CLI with ``--hybrid_bf16_tiles``, every counter at 0
    just before each run: ``train --baseline`` for GCN, SAGE and GAT (under
    ``FUSED``) at hidden 512 for 2 epochs, whose launches are the f32
    runs' with every tile kernel in its bf16 form (no f32 tile kernel),
    and whose best losses sit near those of the f32 runs of phases 6 and
    10 with the same epochs and seed; then the curriculum ``train``
    ``Gc_train_2_Gs_train`` GD for 1 + 1 epochs (GCN) on phase 8's cached
    partition, the Gc phase on bf16 tiles."""
    from fitgnn_tpu_torch.partition import pipeline
    from fitgnn_tpu_torch.train import loop

    phases = {}
    with open(os.path.join(tmp, "results", "baseline", "bench.csv")) as f:
        header, *lines = f.read().splitlines()
    f32_rows = [dict(zip(header.split(","), line.split(",")))
                for line in lines]
    for out_dir, mode, f32_index, rtol in BF16_CLI:
        layer = mode.split()[0]
        launches, _, wall = run_cli(tmp, [
            "train", "--baseline", "--layer_name", layer, "--hidden",
            str(HIDDEN), "--runs", "1", "--epochs1", str(BF16_EPOCHS),
            "--output_dir", out_dir, "--hybrid_bf16_tiles"], MODE_ENV[mode])
        print(f"train {out_dir}: {wall:.1f} s")
        want = {k: BF16_EPOCHS * (STEP[mode].get(k, 0)
                                  + EVAL[mode].get(k, 0))
                + 2 * EVAL[mode].get(k, 0)
                for k in (*STEP[mode], *EVAL[mode])}
        expect(launches, bf16_counts(want), f"train {out_dir}")
        phases[f"train {out_dir}"] = launches
        with open(os.path.join(tmp, "results", "baseline", "bench.csv")) as f:
            row = dict(zip(header.split(","), f.read().splitlines()[-1]
                           .split(",")))
        ref = [r for r in f32_rows if r["layer_name"] == layer
               and r["hidden"] == str(HIDDEN)][f32_index]
        loss, loss32 = float(row["best_loss"]), float(ref["best_loss"])
        print(f"train row {out_dir}: best_acc={row['best_acc']} best_loss="
              f"{row['best_loss']} ave_time={row['ave_time']}; the f32 run: "
              f"best_acc={ref['best_acc']} best_loss={ref['best_loss']} "
              f"ave_time={ref['ave_time']}")
        check(row["layer_name"] == layer and np.isfinite(loss)
              and abs(loss - loss32) <= rtol * loss32,
              f"train {out_dir}: best loss {loss} against the f32 run's "
              f"{loss32} (rtol {rtol})")
    results, partition, run_task = [], pipeline.coarsen_and_partition, \
        loop.run_node_task

    def traced_run(cfg, coarse, batch, verbose=False):
        res = run_task(cfg, coarse, batch, verbose=verbose)
        results.append(res.runs[0])
        return res

    partitioned = []
    with mock.patch.object(loop, "run_node_task", traced_run), \
            mock.patch.object(pipeline, "coarsen_and_partition",
                              lambda *a, **k: partitioned.append(1)
                              or partition(*a, **k)):
        launches, _, wall = run_cli(tmp, [
            "train", "--layer_name", "GCNConv", "--hidden", str(HIDDEN),
            "--exp_setup", "Gc_train_2_Gs_train", "--gradient_method", "GD",
            "--epochs1", "1", "--epochs2", "1", "--runs", "1",
            "--output_dir", "cur_gcnbf16", "--hybrid_bf16_tiles"])
    check(not partitioned, "phase 11's curriculum did not take phase 8's "
          "partition from the cache")
    expect(launches, bf16_counts({k: STEP["GCNConv"][k] + EVAL["GCNConv"][k]
                                  for k in STEP["GCNConv"]}),
           "curriculum cur_gcnbf16")
    res = results[-1]
    check(np.isfinite(res.test_loss) and res.test_loss > 0,
          f"curriculum cur_gcnbf16: test loss {res.test_loss}")
    print(f"curriculum cur_gcnbf16: {wall:.1f} s; Gc epoch ms "
          f"{[round(t * 1e3, 3) for t in res.gc_epoch_seconds]}; Gs epoch s "
          f"{[round(t, 4) for t in res.gs_epoch_seconds]} (GD); test loss "
          f"{res.test_loss:.4f} metric {res.test_acc:.4f}")
    phases["curriculum cur_gcnbf16"] = launches
    return phases


# --- phase 12: the cluster collapse and the ingest planner -----------------

CLUSTER_K = 2048
# (name, layer, build_optimized_graph's collapse)
CLUSTER_OPS = (("gcn_agg", "GCNConv", dict(cluster_agg=CLUSTER_K)),
               ("gcn_agg_exact", "GCNConv", dict(cluster_agg=CLUSTER_K,
                                                 cluster_agg_exact=4096)),
               ("gat_att", "GATConv", dict(cluster_att=CLUSTER_K)))
# the bench graph's nodes padded to a whole cluster of 2,048
CLUSTER_N_PAD = 169_984
CLUSTER_EPOCHS = 2
# phase 4's fused GAT step under the exact max, which folds the summary
# rows' max into it: K7rm in both layers beside the fused step's kernels
STEP["GATConv fused den exact"] = {**STEP["GATConv fused"], "K7rm": 2}
EVAL["GATConv fused den exact"] = {**EVAL["GATConv fused"], "K7rm": 2}
MODE_ENV["GATConv fused den exact"] = {**FUSED, "FITGNN_GAT_GLOBAL_MAX": "0"}


def cluster_operators(ds) -> dict:
    """The bench graph's operators under ``cluster_agg`` 2048 (GCN), with
    ``cluster_agg_exact`` 4096, and under ``cluster_att`` 2048 (GAT), at the
    default threshold; prints each one's N_pad, C, tiles, stragglers,
    table entries and the table's type and size."""
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph

    graphs = {}
    for name, layer, collapse in CLUSTER_OPS:
        t0 = time.perf_counter()
        g, _ = build_optimized_graph(ds.x, ds.senders, ds.receivers,
                                     y=ds.y, train_mask=ds.train_mask,
                                     layer_name=layer, seed=0, **collapse)
        h = g.aux
        cc = h.cluster_count
        mib = cc.numel() * cc.element_size() / 2 ** 20
        print(f"cluster ingest {name}: {time.perf_counter() - t0:.1f} s; "
              f"N_pad {g.num_nodes_padded}, C {cc.shape[1]}, "
              f"{h.bsr.nnz_blocks} tiles (with fillers), {h.num_coo_edges} "
              f"straggler edges, {int((cc > 0).sum())} cluster entries, "
              f"table {cc.dtype} {mib:.1f} MiB")
        check(g.num_nodes_padded == CLUSTER_N_PAD
              and cc.shape == (CLUSTER_N_PAD, CLUSTER_N_PAD // CLUSTER_K)
              and h.cluster_size == CLUSTER_K,
              f"{name}: N_pad {g.num_nodes_padded}, table {tuple(cc.shape)}")
        check(cc.dtype == (torch.bfloat16 if layer == "GATConv"
                           else torch.float32),
              f"{name}: table of type {cc.dtype}")
        exact = collapse.get("cluster_agg_exact", 0)
        check((h.num_coo_edges > 1) == bool(exact),
              f"{name}: {h.num_coo_edges} straggler edges left")
        graphs[name] = g
    return graphs


def phase_cluster_steps(device, graphs) -> dict:
    """On each collapsed operator one training step (hidden 512, dropout
    off, seed-0 init) with the kernels and with the plain versions patched
    in: the loss and every gradient, and the step's launches (the collapse
    launches none of the port's kernels).  GCN on both static operators,
    GAT on the attention one under the default switches and under
    ``FUSED_TILES=1 SEGMM_DEN=1 GLOBAL_MAX=0`` (the exact max folds the
    summary rows).  First the static term alone on the card against
    float64 on the host."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.ops.hybrid_spmm import _cluster_static_term
    from fitgnn_tpu_torch.train.losses import masked_nll

    h = graphs["gcn_agg"].aux
    hd = h.to(device)
    x = torch.randn((h.num_nodes, NUM_FEATURES), device=device,
                    generator=torch.Generator(device=device).manual_seed(12))
    with torch.inference_mode():
        got = _cluster_static_term(hd, x)
    torch.cuda.synchronize()
    xs = x.double().cpu() * h.cluster_member.double()[:, None]
    means = (xs.reshape(-1, CLUSTER_K, NUM_FEATURES).sum(1)
             * h.cluster_scale.double()[:, None])
    compare("cluster_agg static term on the card vs float64",
            got.double().cpu(), h.cluster_count.double() @ means)
    del hd, x, got
    phases = {}
    for name, mode in (("gcn_agg", "GCNConv"), ("gcn_agg_exact", "GCNConv"),
                       ("gat_att", "GATConv"),
                       ("gat_att", "GATConv fused den exact")):
        layer = mode.split()[0]
        gd = graphs[name].to(device)
        model = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                          dropout_rate=0.0)
        model = model.reset_parameters(torch.Generator().manual_seed(0)).to(
            device).train()

        def step():
            model.zero_grad(set_to_none=True)
            loss = masked_nll(model(gd.x, gd), gd.y, gd.train_mask)
            loss.backward()
            torch.cuda.synchronize()
            return loss.detach(), {k: p.grad.detach().clone()
                                   for k, p in model.named_parameters()}

        what = f"cluster {name} {mode}"
        with switches(MODE_ENV[mode]):
            reset_counts()
            t0 = time.perf_counter()
            loss_k, grads_k = step()
            secs = time.perf_counter() - t0
            launches = read_counts()
            expect(launches, STEP[mode], f"{what} train step")
            phases[f"{what} step"] = launches
            reset_counts()
            with plain_versions():
                loss_p, grads_p = step()
        expect(read_counts(), {}, f"{what} train step, plain versions")
        compare(f"{what} loss kernels vs plain", loss_k.reshape(1),
                loss_p.reshape(1))
        for k in grads_p:
            compare(f"{what} grad {k}", grads_k[k], grads_p[k])
        print(f"{what}: loss {float(loss_k):.6f}, first step {secs:.3f} s")
        del model, gd, grads_k, grads_p
        torch.cuda.empty_cache()
    return phases


def phase_cluster_cli(tmp) -> dict:
    """Through the CLI, every counter at 0 just before each run: ``train
    --baseline --cluster_aggregation 2048`` (GCN) and ``--cluster_attention
    2048`` (GAT) for 2 epochs, ``train --baseline --auto_config`` (GCN; the
    planner's pick and its predicted ms printed), each against the counts
    per step and eval forward that phase 4 confirmed, with its CSV row;
    then the curriculum ``train`` GD for 1 + 1 epochs with
    ``--cluster_aggregation 2048 --fused_epochs`` on phase 8's cached
    partition, the fused Gc phase under ``set_sync_debug_mode("error")``."""
    from fitgnn_tpu_torch.graph import planner
    from fitgnn_tpu_torch.partition import pipeline
    from fitgnn_tpu_torch.train import loop, steps

    phases = {}
    plans, plan = [], planner.plan_config

    def traced_plan(*args, **kwargs):
        plans.append(plan(*args, **kwargs))
        return plans[-1]

    runs = (("gcn512agg", "GCNConv", ["--cluster_aggregation",
                                      str(CLUSTER_K)]),
            ("gat512att", "GATConv", ["--cluster_attention",
                                      str(CLUSTER_K)]),
            ("gcn512auto", "GCNConv", ["--auto_config"]))
    for out_dir, mode, flags in runs:
        with mock.patch.object(planner, "plan_config", traced_plan):
            launches, _, wall = run_cli(tmp, [
                "train", "--baseline", "--layer_name", mode, "--hidden",
                str(HIDDEN), "--runs", "1", "--epochs1", str(CLUSTER_EPOCHS),
                "--output_dir", out_dir, *flags])
        want = {k: CLUSTER_EPOCHS * (STEP[mode].get(k, 0)
                                     + EVAL[mode].get(k, 0))
                + 2 * EVAL[mode].get(k, 0)
                for k in (*STEP[mode], *EVAL[mode])}
        expect(launches, want, f"train {out_dir}")
        phases[f"train {out_dir}"] = launches
        with open(os.path.join(tmp, "results", "baseline", "bench.csv")) as f:
            header, *lines = f.read().splitlines()
        row = dict(zip(header.split(","), lines[-1].split(",")))
        loss = float(row["best_loss"])
        check(row["layer_name"] == mode and np.isfinite(loss) and loss > 0,
              f"train {out_dir}: bad row {lines[-1]}")
        print(f"train {out_dir}: {wall:.1f} s; best_acc={row['best_acc']} "
              f"best_loss={row['best_loss']} ave_time={row['ave_time']}")
        if out_dir == "gcn512auto":
            check(len(plans) == 1, f"the planner ran {len(plans)} times")
            p = plans[0]
            print(f"train {out_dir}: the planner picked threshold "
                  f"{p.min_block_edges}, predicted {p.predicted_ms:.4f} ms "
                  f"(48: {p.alternatives[48]:.4f} ms), cluster_k "
                  f"{p.cluster_k}, max_buckets {p.max_buckets}, "
                  f"chunk_budget {p.chunk_budget}")
            check(p.min_block_edges in planner.THRESHOLD_CANDIDATES,
                  f"planner pick {p.min_block_edges}")

    results, partition, run_task = [], pipeline.coarsen_and_partition, \
        loop.run_node_task
    fused_fn = steps.gc_train_epochs_fused

    def traced_run(cfg, coarse, batch, verbose=False):
        res = run_task(cfg, coarse, batch, verbose=verbose)
        results.append(res.runs[0])
        return res

    def strict_fused(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fused_fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    partitioned = []
    with mock.patch.object(loop, "run_node_task", traced_run), \
            mock.patch.object(steps, "gc_train_epochs_fused",
                              strict_fused), \
            mock.patch.object(pipeline, "coarsen_and_partition",
                              lambda *a, **k: partitioned.append(1)
                              or partition(*a, **k)):
        launches, _, wall = run_cli(tmp, [
            "train", "--layer_name", "GCNConv", "--hidden", str(HIDDEN),
            "--exp_setup", "Gc_train_2_Gs_train", "--gradient_method", "GD",
            "--epochs1", "1", "--epochs2", "1", "--runs", "1",
            "--output_dir", "cur_gcnagg", "--fused_epochs",
            "--cluster_aggregation", str(CLUSTER_K)])
    check(not partitioned, "phase 12's curriculum did not take phase 8's "
          "partition from the cache")
    expect(launches, {k: STEP["GCNConv"][k] + EVAL["GCNConv"][k]
                      for k in STEP["GCNConv"]}, "curriculum cur_gcnagg")
    res = results[-1]
    check(np.isfinite(res.test_loss) and res.test_loss > 0
          and res.gc_fused_seconds is not None,
          f"curriculum cur_gcnagg: test loss {res.test_loss}, fused "
          f"{res.gc_fused_seconds}")
    print(f"curriculum cur_gcnagg: {wall:.1f} s; fused Gc phase "
          f"{res.gc_fused_seconds * 1e3:.3f} ms (1 epoch); Gs epoch s "
          f"{[round(t, 4) for t in res.gs_epoch_seconds]} (GD); test loss "
          f"{res.test_loss:.4f} metric {res.test_acc:.4f}")
    phases["curriculum cur_gcnagg"] = launches
    return phases


# the graph phase: QM9-shaped molecules (9–29 atoms, 11 features) from the
# port's qm9_like_dataset, the count cut from QM9's 130,831 for the host's
# per-molecule coarsening; GraphModel at hidden 512, 2 layers, chunks of
# 128 graphs, the 1-hop halo subgraphs
GRAPH_COUNT = 2048
QM9_COUNT = 130_831
GRAPH_INFER = 256
GRAPH_FLAGS = ("--hidden", str(HIDDEN), "--num_layers1", "2", "--extra_node",
               "--coarsening_ratio", "0.5", "--coarsening_method",
               "variation_neighborhoods")
GRAPH_RUNS = (
    ("qm9proxy", "graph_reg", "GCNConv", "Gc_train_2_Gs_train", 2, 2),
    ("qm9proxycls", "graph_cls", "GATConv", "Gc_train_2_Gs_infer", 2, 0))


def phase_graph(device, tmp) -> dict:
    """The graph-level tasks through the port's CLI on the card: the
    QM9-shaped sets written as ``<name>_graphs.npz``, ``train --task
    graph_reg`` (GCN ``Gc_train_2_Gs_train``) and ``--task graph_cls``
    (GAT ``Gc_train_2_Gs_infer``) at hidden 512 in chunks of 128, then
    ``infer --task graph_reg`` from the first run's checkpoint (the Gs and
    Gc rows); each with every counter at 0 just before and no launch of
    the port's kernels after (the JAX graph path reaches no Pallas
    kernel).  Then one train chunk's forward in both views on the card
    against the CPU with each run's saved parameters."""
    from fitgnn_tpu_torch.data import graph_level
    from fitgnn_tpu_torch.data.datasets import GraphDataset, save_graph_cache
    from fitgnn_tpu_torch.data.synthetic import qm9_like_dataset
    from fitgnn_tpu_torch.models.models import GraphModel
    from fitgnn_tpu_torch.train import graph_loop
    from fitgnn_tpu_torch.train.checkpoint import restore_params
    from fitgnn_tpu_torch.utils.results import (INFERENCE_HEADER,
                                                TRAIN_GRAPH_HEADER)

    t_phase = time.perf_counter()
    print(f"graph phase: {GRAPH_COUNT} QM9-shaped molecules (QM9 has "
          f"{QM9_COUNT:,}; the count is cut for the host's per-molecule "
          "coarsening, which every train and infer call repeats), 9-29 "
          "atoms, 11 features")
    graphs, y_reg, y_cls = qm9_like_dataset(GRAPH_COUNT, seed=0)
    for name, y in (("qm9proxy", y_reg), ("qm9proxycls", y_cls)):
        os.makedirs(os.path.join(tmp, "dataset", name))
        save_graph_cache(os.path.join(tmp, "dataset", name,
                                      f"{name}_graphs.npz"),
                         GraphDataset(name, graphs, y))

    seen = {"prep": [0.0, 0], "collate": [], "runs": []}
    prepare, collate, run_task = (graph_level.prepare_graph_sample,
                                  graph_level.collate_graph_level_batches,
                                  graph_loop.run_graph_task)

    def timed_prepare(*args, **kwargs):
        t0 = time.perf_counter()
        out = prepare(*args, **kwargs)
        seen["prep"][0] += time.perf_counter() - t0
        seen["prep"][1] += 1
        return out

    def timed_collate(*args, **kwargs):
        t0 = time.perf_counter()
        out = collate(*args, **kwargs)
        seen["collate"].append(time.perf_counter() - t0)
        return out

    def traced_run(cfg, train_b, val_b, test_b, verbose=False):
        res = run_task(cfg, train_b, val_b, test_b, verbose=verbose)
        seen["runs"].append((cfg, train_b[0], res))
        return res

    phases, peaks = {}, {}
    patches = (mock.patch.object(graph_level, "prepare_graph_sample",
                                 timed_prepare),
               mock.patch.object(graph_level, "collate_graph_level_batches",
                                 timed_collate),
               mock.patch.object(graph_loop, "run_graph_task", traced_run))
    for patch in patches:
        patch.start()
    try:
        for name, task, layer, setup, ep1, ep2 in GRAPH_RUNS:
            seen["prep"], seen["collate"] = [0.0, 0], []
            torch.cuda.reset_peak_memory_stats()
            launches, _, wall = run_cli(tmp, [
                "train", "--task", task, "--layer_name", layer,
                "--exp_setup", setup, "--epochs1", str(ep1), "--epochs2",
                str(ep2), "--batch_size", "128", "--output_dir",
                f"g_{name}", *GRAPH_FLAGS], dataset=name)
            peaks[name] = torch.cuda.max_memory_allocated() / 2**20
            check(not any(launches.values()),
                  f"graph train {name}: launches {launches}")
            phases[f"graph train {name}"] = launches
            cfg, chunk, res = seen["runs"][-1]
            secs, count = seen["prep"]
            check(count == GRAPH_COUNT, f"graph train {name}: {count} "
                  "molecules coarsened")
            print(f"graph train {name} ({task} {layer} {setup}, {ep1} + "
                  f"{ep2} epochs): {wall:.1f} s wall; host "
                  f"prepare_graph_sample {1e3 * secs / count:.3f} ms a "
                  f"molecule ({secs:.1f} s for {count}); collation "
                  f"{sum(seen['collate']):.2f} s (train, val, test); chunk "
                  f"gc {tuple(chunk.gc.x.shape)} edges "
                  f"{tuple(chunk.gc.senders.shape)}, gs "
                  f"{tuple(chunk.gs.x.shape)} edges "
                  f"{tuple(chunk.gs.senders.shape)}; Gc epoch s "
                  f"{[round(t, 4) for t in res.gc_epoch_seconds]}, Gs "
                  f"epoch s {[round(t, 4) for t in res.gs_epoch_seconds]}; "
                  f"peak device memory {peaks[name]:.1f} MiB; launches 0")
            check(len(res.gc_epoch_seconds) == ep1
                  and len(res.gs_epoch_seconds) == ep2,
                  f"graph train {name}: epochs {res}")
            with open(os.path.join(tmp, "results", f"{name}.csv")) as f:
                lines = f.read().splitlines()
            check(lines[0] == TRAIN_GRAPH_HEADER and len(lines) == 2,
                  f"graph train {name}: results rows {lines}")
            row = dict(zip(lines[0].split(","), lines[1].split(",")))
            print(f"  row: {lines[1]}")
            for k in ("best_test_loss", "best_test_acc"):
                check(np.isfinite(float(row[k])),
                      f"graph train {name}: {k} {row[k]}")

        torch.cuda.reset_peak_memory_stats()
        launches, _, wall = run_cli(tmp, [
            "infer", "--task", "graph_reg", "--num_test_samples",
            str(GRAPH_INFER), "--output_dir", "g_qm9proxy", *GRAPH_FLAGS],
            dataset="qm9proxy")
    finally:
        for patch in patches:
            patch.stop()
    check(not any(launches.values()), f"graph infer: launches {launches}")
    phases["graph infer"] = launches
    with open(os.path.join(tmp, "inference_results", "graph_reg.csv")) as f:
        lines = f.read().splitlines()
    check(lines[0] == INFERENCE_HEADER and len(lines) == 3,
          f"graph infer: rows {lines}")
    for line in lines[1:]:
        row = dict(zip(lines[0].split(","), line.split(",")))
        for k in ("avg_inf_time", "avg_loss", "avg_inf_time_device"):
            check(np.isfinite(float(row[k])) and float(row[k]) > 0,
                  f"graph infer {row['exp_setup']}: {k} {row[k]}")
        print(f"graph infer {row['exp_setup']} ({GRAPH_INFER} molecules, "
              f"one forward each): avg_inf_time "
              f"{1e3 * float(row['avg_inf_time']):.4f} ms, "
              f"avg_inf_time_device "
              f"{1e3 * float(row['avg_inf_time_device']):.4f} ms, avg_loss "
              f"{float(row['avg_loss']):.4f}; {wall:.1f} s wall, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
              " MiB; launches 0")
        print(f"  row: {line}")
    check([line.split(",")[3] for line in lines[1:]]
          == ["fitgnn_gs", "fitgnn_gc"], "graph infer: the views' rows")

    # one train chunk's forward in both views, the card against the CPU
    reset_counts()
    for cfg, chunk, _ in seen["runs"]:
        m = GraphModel(cfg.layer_name, in_dim=chunk.gc.x.shape[1],
                       hidden=cfg.hidden, num_layers=cfg.num_layers,
                       out_dim=cfg.out_dim, classify=cfg.classify)
        m.load_state_dict(restore_params(os.path.join(tmp, cfg.save_path)))
        m.eval()
        with torch.inference_mode():
            ref = {v: graph_loop._forward(m, chunk, v) for v in ("gc", "gs")}
            md, bd = m.to(device), chunk.to(device)
            got = {v: graph_loop._forward(md, bd, v) for v in ("gc", "gs")}
        for v in ("gc", "gs"):
            compare(f"graph {cfg.layer_name} {v} forward, card against CPU",
                    got[v].cpu(), ref[v])
    check(not any(read_counts().values()),
          f"graph forwards: launches {read_counts()}")
    print(f"graph phase: {time.perf_counter() - t_phase:.1f} s")
    return phases


# ---- phase 14: tiles of edge 256 ----------------------------------------

EDGE = 256
# the bench graph's two operators at edge 256 (bench.py's
# FITGNN_BENCH_BLOCK=256 builds build_hybrid(block=256); its threshold rule
# takes 48 × 4 = 192 with the edge) and the split they give (live tiles,
# of which on the diagonal; live diagonal blocks; stragglers).  The split
# is the JAX package's rule, which counts the weight-0 padding edges
# toward a tile's threshold: at 192 they make the last diagonal block,
# which holds the pad node, dense (662 blocks, not the 661 that the real
# edges alone reach).  tests/test_torch_port_block.py holds the split
# against the JAX package's on a cut of the graph.
EDGE_OPS = {"t48": (dict(min_block_edges=48), (1_174, 662, 0, 225_132)),
            "t192diag": (dict(min_block_edges=192, use_diag=True),
                         (16, 0, 662, 284_690))}
# the live 128-wide quadrants of the occupancy words (forward direction)
# and the quadrants the walk without words reads (every tile's, fillers and
# group pads included): threshold 48, and its grouped layout
EDGE_QUADS = {"t48": (3_115, 4_696), "group2": (3_115, 6_944)}
# the forms counted at edge 256 ("K1@256", "K1bf@256", ...)
EDGE_IDS = ("K1", "K2", "K8", "K9", "K1bf", "K2bf", "K8bf", "K9bf")
# one GCN train step (hidden 512, dropout 0.5 through K11) and one eval
# forward on each operator at 256: phase 4's and 5's counts at 128
EDGE_STEP = {"t48": {"K3": 3, "K1": 3, "K11": 4},
             "t192diag": {"K3": 3, "K8": 3, "K1": 3, "K11": 4},
             "group2": {"K3": 3, "K9": 3, "K11": 4}}
EDGE_EVAL = {"t48": {"K3": 2, "K1": 2},
             "t192diag": {"K3": 2, "K8": 2, "K1": 2},
             "group2": {"K3": 2, "K9": 2}}
EDGE_TIMED_STEPS = 10


# GAT's forms counted at edge 256: the two-stage path's (phase 15) and the
# fused path's (phase 16), with the bf16 forms of the fused kernels that
# read the mask (K7sums reads none), and the two-stage path's on bf16
# activations (phase 27)
GAT_EDGE_IDS = ("K4", "K4T", "K5", "K7rm", "K7f", "K7bt", "K7s", "K7sums",
                "K7rmbf", "K7fbf", "K7btbf", "K7sbf", "K4a", "K4Ta", "K5a")


def eval_and_step(model, gd, device) -> tuple:
    """One eval forward of ``model`` on ``gd``, then one ``gc_train_step``
    (Adam with L2, dropout drawn from a seed-0 generator on the card):
    (the forward, the loss, every parameter's gradient)."""
    from fitgnn_tpu_torch.train import steps

    model.eval()
    with torch.inference_mode():
        fwd = model(gd.x, gd)
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    gen = torch.Generator(device=device).manual_seed(0)
    loss = steps.gc_train_step(model, opt, gd, gd.y, gd.train_mask, gen,
                               "classification")
    torch.cuda.synchronize()
    return fwd, loss, {k: p.grad.detach().clone()
                       for k, p in model.named_parameters()}


def step_ms(what: str, make_model, device, graphs) -> None:
    """Prints the ``gc_train_step`` ms (CUDA events over EDGE_TIMED_STEPS
    steps) of a fresh ``make_model()`` on each (name, CPU graph) in turn,
    in one call."""
    from fitgnn_tpu_torch.train import steps

    times = {}
    for name, gr in graphs:
        gd = gr.to(device)
        model = make_model()
        opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
        gen = torch.Generator(device=device).manual_seed(0)
        times[name] = cuda_ms(lambda: steps.gc_train_step(
            model, opt, gd, gd.y, gd.train_mask, gen, "classification"),
            EDGE_TIMED_STEPS)
        del gd, model, opt
        torch.cuda.empty_cache()
    print(f"gc_train_step ms ({what}, CUDA events over {EDGE_TIMED_STEPS} "
          "steps): " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))


def at_edge(counts: dict) -> dict:
    """Launch counts of a run at edge 256, the tile kernels under their
    ``@256`` IDs."""
    return {f"{k}@{EDGE}" if k in EDGE_IDS + GAT_EDGE_IDS else k: v
            for k, v in counts.items()}


def bf16_tiles(h):
    """A hybrid operator with its tiles and diagonal blocks in bf16 (what
    ``build_hybrid(tile_dtype=torch.bfloat16)`` builds: f32, then cast, the
    occupancy words made of the cast tiles).  An ``att_unit`` plan keeps
    its words, which the kernels read against the cast mask: checked here
    to be the cast tiles' own (a 0/1 mask keeps its non-zeros in bf16)."""

    def cast(b, **kw):
        return dataclasses.replace(b, blocks=b.blocks.to(torch.bfloat16),
                                   **kw)

    b = h.bsr
    bsr = cast(b, transpose=cast(b.transpose))
    plan = h.dyn_plan
    if plan is not None and plan.words is not None:
        check(torch.equal(plan.words, bsr.quad_bits),
              "bf16 tiles: the plan's occupancy words are not the cast "
              "mask's")
    return dataclasses.replace(
        h, bsr=bsr, diag_blocks=None if h.diag_blocks is None
        else h.diag_blocks.to(torch.bfloat16))


def block_operators(g) -> dict:
    """The bench graph's GCN operators at edge 256 on phase 3's node order
    (``build_hybrid(block=256)``, as ``bench.py`` composes it): threshold
    48, threshold 192 with ``use_diag``, and threshold 48 with
    ``tile_group=2``; their tiles, diagonal blocks and stragglers printed
    beside ``EDGE_OPS``'."""
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

    s, r = g.senders.numpy(), g.receivers.numpy()
    w, n = g.edge_weight.numpy(), g.num_nodes_padded
    t0 = time.perf_counter()
    ops = {name: build_hybrid(s, r, w, n, block=EDGE, use_segmm=True, **kw)
           for name, (kw, _) in EDGE_OPS.items()}
    ops["group2"] = build_hybrid(s, r, w, n, block=EDGE, use_segmm=True,
                                 min_block_edges=48, tile_group=2)
    print(f"edge-{EDGE} ingest (3 operators): "
          f"{time.perf_counter() - t0:.1f} s; N_pad {n} = {n // EDGE} x "
          f"{EDGE}")
    for name, h in ops.items():
        b = h.bsr
        check(b is not None and b.block == EDGE
              and b.blocks.shape[1:] == (EDGE, EDGE),
              f"edge {EDGE} {name}: no {EDGE}-wide tile")
        live = (b.blocks != 0).flatten(1).any(1)
        tiles = int(live.sum())
        on_diag = int((live & (b.rows == b.cols)).sum())
        diag = (0 if h.diag_blocks is None
                else int((h.diag_blocks != 0).flatten(1).any(1).sum()))
        stragglers = int((h.weights != 0).sum())
        got = (tiles, on_diag, diag, stragglers)
        ref = EDGE_OPS.get(name, (None, got))[1]
        print(f"edge {EDGE} {name}: {tiles} tiles ({on_diag} on the "
              f"diagonal; +{b.nnz_blocks - tiles} fillers and pads), {diag} "
              f"diagonal blocks (diag_r {h.diag_r}), {stragglers} "
              f"stragglers; f32 tiles {b.blocks.numel() * 4 / 2**20:.1f} MiB "
              f"a direction; expected {ref} (diff "
              f"{tuple(a - c for a, c in zip(got, ref))})")
        for what, d in (("forward", b), ("transpose", b.transpose)):
            live, _ = live_quadrants(d)
            print(f"edge {EDGE} {name} {what}: {live} live 128-wide "
                  f"quadrants of {d.nnz_blocks * (EDGE // 128) ** 2} "
                  f"(occupancy words {d.quad_bits.numel() * 8} bytes); "
                  f"expected {EDGE_QUADS.get(name, ('-', '-'))} forward")
    check(ops["t192diag"].diag_r > 0, "t192diag: no K8 chain")
    return ops


def live_quadrants(b) -> tuple:
    """The live 128-wide quadrants of ``b``'s occupancy words and the
    distinct 128-row X slabs they reach; fails unless the words are the
    quadrants' occupancy, counted here from the tiles' magnitudes."""
    nq = b.block // 128
    words = (b.quad_bits.unsqueeze(1) >> torch.arange(
        nq * nq, device=b.quad_bits.device)) & 1
    occupied = b.blocks.float().abs().reshape(-1, nq, 128, nq, 128).sum(
        (2, 4)).reshape(-1, nq * nq) != 0
    check(torch.equal(words.bool(), occupied),
          f"edge {b.block}: occupancy words differ from the tiles")
    k, ij = words.nonzero(as_tuple=True)
    slabs = torch.unique(b.cols.long()[k] * nq + ij % nq).numel()
    return k.numel(), slabs


def phase_block_kernels(device, ops) -> dict:
    """K1 (forward and on the transpose), K2, K9 (``tile_group=2``) and K8
    (forward and transposed, from init and from zero) at edge 256, f32
    and bf16 tiles, at F=128 and 512 (K2 and K9 also on the transpose at
    512), each against its plain version with its kernel, plain and
    library times and its bound (live tiles of 256 x 256 at 4 or 2 bytes
    an entry).  K1, K2 and K9 walk the live quadrants of the occupancy
    words: each also bit for bit against the walk without words (null
    words), with that walk's time (``nowords_ms``); their bound is over
    the live 128-wide quadrants, the slabs they reach and the output, and
    the bound over every quadrant of a live tile stays beside it as
    ``bound_tiles_ms``."""
    from fitgnn_tpu_torch.ops.bsr_spmm import (bsr_spmm_acc,
                                               bsr_spmm_acc_plain,
                                               bsr_spmm_fwd,
                                               bsr_spmm_grouped,
                                               bsr_spmm_plain)
    from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm, diag_spmm_plain

    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(14)
    out = {f"{k}@{EDGE}": [] for k in EDGE_IDS}
    for tt in ("f32", "bf16"):
        cast = bf16_tiles if tt == "bf16" else (lambda h: h)
        suffix, width = ("bf", 2) if tt == "bf16" else ("", 4)
        h48 = cast(ops["t48"]).to(device)
        bg = cast(ops["group2"]).bsr.to(device)
        hd = cast(ops["t192diag"]).to(device)
        diag, r8 = hd.diag_blocks, hd.diag_r
        n = h48.num_nodes
        nb = n // EDGE
        diag_live = int((diag != 0).flatten(1).any(1).sum())
        diag_nnz = int((diag != 0).sum())
        diag32 = diag.float()
        # (K1 and K2's operator, K9's, the library's CSR, tile non-zeros,
        # live tiles, distinct slabs of the live tiles, live quadrants,
        # distinct slabs of the live quadrants) a direction
        rows = {}
        for what, b, b9 in (("forward", h48.bsr, bg),
                            ("transpose", h48.bsr.transpose, bg.transpose)):
            live = (b.blocks != 0).flatten(1).any(1)
            csr, nnz = tile_csr(dataclasses.replace(
                b, blocks=b.blocks.float()), n)
            quads = live_quadrants(b)
            check(quads == live_quadrants(b9),
                  f"edge {EDGE} {tt} {what}: the grouped layout's live "
                  "quadrants differ")
            rows[what] = (b, b9, csr, nnz, int(live.sum()),
                          int(torch.unique(b.cols[live]).numel()), *quads)

        def show(k, sh):
            print(f"  {k}{suffix}@{EDGE} {sh['shape']}: kernel_ms="
                  f"{sh['ms']:.4f} "
                  + (f"nowords_ms={sh['nowords_ms']:.4f} "
                     if "nowords_ms" in sh else "")
                  + f"plain_ms={sh['plain_ms']:.4f} "
                  f"library_ms={sh['library_ms']:.4f} bound_ms="
                  f"{sh['bound_ms']:.4f} ({sh['bound_by']})"
                  + (f" bound_tiles_ms={sh['bound_tiles_ms']:.4f}"
                     if "bound_tiles_ms" in sh else ""))

        with torch.inference_mode():
            for feat in (NUM_FEATURES, HIDDEN):
                x = torch.randn((n, feat), generator=gen, device=device)
                xl = x.to(torch.bfloat16).float() if tt == "bf16" else x
                init = torch.randn((n, feat), generator=gen, device=device)
                print(f"edge {EDGE} {tt} F={feat}:")
                for what, (b, b9, csr, nnz, tiles, uniq, quads,
                           qslabs) in rows.items():
                    tag = (f"F={feat}"
                           f"{' transpose' if what == 'transpose' else ''}")
                    # the live tiles (or quadrants), the indices, the
                    # distinct slabs, init (K1) and out; 2 FLOPs per tile
                    # non-zero and feature
                    flops = 2.0 * nnz * feat
                    live_bytes = (quads * 128 * 128 * width
                                  + qslabs * 128 * feat * 4 + n * feat * 4)
                    for k, bk, walk, plain, ins, lib, on_path in (
                            ("K1", b, bsr_spmm_acc, bsr_spmm_acc_plain,
                             (x, init), lambda: torch.sparse.addmm(
                                 init, csr, xl),
                             what == "forward" or feat == HIDDEN),
                            ("K2", b, bsr_spmm_fwd, bsr_spmm_plain, (x,),
                             lambda: torch.sparse.mm(csr, xl),
                             what == "forward"),
                            ("K9", b9, bsr_spmm_grouped, bsr_spmm_plain,
                             (x,), lambda: torch.sparse.mm(csr, xl),
                             what == "forward" or feat == HIDDEN)):
                        if what == "transpose" and k != "K1" \
                                and feat != HIDDEN:
                            continue
                        with_init = len(ins) == 2
                        b1, _ = bound(
                            tiles * EDGE * EDGE * width
                            + ((2 if with_init else 1) * bk.nnz_blocks + nb
                               + 1) * 4
                            + uniq * EDGE * feat * 4
                            + (2 if with_init else 1) * n * feat * 4, flops)
                        bl, byl = bound(live_bytes + (n * feat * 4
                                                      if with_init else 0),
                                        flops)
                        nowords = dataclasses.replace(bk, words=False)
                        got = walk(bk, *ins)
                        ref = plain(bk, *ins)
                        without = walk(nowords, *ins)
                        torch.cuda.synchronize()
                        err = compare(f"{k}{suffix}@{EDGE} {walk.__name__} "
                                      f"{tag}", got, ref)
                        check(torch.equal(got, without),
                              f"{k}{suffix}@{EDGE} {tag}: the walk with "
                              "occupancy words is not the walk without "
                              "them bit for bit")
                        compare(f"{k}{suffix}@{EDGE} vs the grid walk's "
                                f"plain version without words {tag}", got,
                                plain(dataclasses.replace(b, words=False),
                                      *ins))
                        compare(f"{k}{suffix}@{EDGE} library {tag}", lib(),
                                ref)
                        sh = dict(
                            F=feat, shape=tag, on_path=on_path, **err,
                            bound_ms=bl, bound_by=byl, bound_tiles_ms=b1,
                            live_quadrants=quads,
                            ms=cuda_ms(lambda: walk(bk, *ins), 20),
                            nowords_ms=cuda_ms(lambda: walk(nowords, *ins),
                                               20),
                            plain_ms=cuda_ms(lambda: plain(bk, *ins), 5),
                            library_ms=cuda_ms(lib, 20))
                        out[f"{k}{suffix}@{EDGE}"].append(sh)
                        show(k, sh)
                        del got, ref, without
                x3, i3 = xl.reshape(nb, EDGE, feat), init.reshape(nb, EDGE,
                                                                  feat)
                for transpose in (False, True):
                    a3 = diag32.transpose(1, 2) if transpose else diag32
                    for with_init in (True, False):
                        it = init if with_init else None
                        tag = (f"F={feat}{' transpose' if transpose else ''}"
                               f"{' init' if with_init else ''}")
                        got = diag_spmm(diag, x, r8, transpose, it)
                        ref = diag_spmm_plain(diag, x, r8, transpose, it)
                        torch.cuda.synchronize()
                        err = compare(f"K8{suffix}@{EDGE} diag_spmm {tag}",
                                      got, ref)

                        def lib8(a3=a3, with_init=with_init):
                            if with_init:
                                return torch.baddbmm(i3, a3, x3)
                            return torch.bmm(a3, x3)

                        compare(f"K8{suffix}@{EDGE} library torch.baddbmm "
                                f"{tag}", lib8().reshape(n, feat), ref)
                        b8, by8 = bound(diag_live * EDGE * EDGE * width
                                        + n * feat * 4 * (3 if with_init
                                                          else 2),
                                        2.0 * diag_nnz * feat)
                        sh = dict(
                            F=feat, shape=tag, transpose=transpose,
                            init=with_init,
                            on_path=with_init and (feat == HIDDEN
                                                   or not transpose),
                            **err, bound_ms=b8, bound_by=by8,
                            ms=cuda_ms(lambda: diag_spmm(
                                diag, x, r8, transpose, it), 20),
                            plain_ms=cuda_ms(lambda: diag_spmm_plain(
                                diag, x, r8, transpose, it), 5),
                            library_ms=cuda_ms(lib8, 20))
                        out[f"K8{suffix}@{EDGE}"].append(sh)
                        show("K8", sh)
                del x, xl, init, x3, i3, got, ref
        del h48, bg, hd, diag, diag32, rows
        torch.cuda.empty_cache()
    print(f"edge-{EDGE} kernels: {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_block_steps(device, g, ops) -> dict:
    """Through the library surface, every counter at 0 just before each
    counted run: on each operator at edge 256 (threshold 48: K1;
    threshold 192 with ``use_diag``: K8 and K1; ``tile_group=2``: K9; K3
    on each), f32 and bf16 tiles, one eval forward and one
    ``gc_train_step`` of GCN at hidden 512 with dropout 0.5 through K11
    from seed-0 weights, launching phase 4's and 5's counts at 128 and
    held against the same run with the plain versions (the eval forward,
    the loss and every gradient); two eval forwards on the forward-only
    operator (K2) against the threshold-48 operator's; then the
    ``gc_train_step`` ms of each f32 operator beside the edge-128
    operator's, in one call."""
    from fitgnn_tpu_torch.models.models import NodeModel

    t_phase = time.perf_counter()
    phases = {}

    def model_():
        m = NodeModel("GCNConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                      dropout_rate=0.5, fused_dropout=True,
                      bit_dropout=False)
        return m.reset_parameters(torch.Generator().manual_seed(0)).to(
            device)

    def run(gd):
        return eval_and_step(model_(), gd, device)

    evals = {}
    for tt in ("f32", "bf16"):
        for name in ("t48", "t192diag", "group2"):
            h = bf16_tiles(ops[name]) if tt == "bf16" else ops[name]
            gd = g._replace(aux=h).to(device)
            what = f"edge{EDGE} gcn512 {name} {tt} step and eval"
            want = {k: EDGE_STEP[name].get(k, 0) + EDGE_EVAL[name].get(k, 0)
                    for k in (*EDGE_STEP[name], *EDGE_EVAL[name])}
            want = at_edge(bf16_counts(want) if tt == "bf16" else want)
            reset_counts()
            got = run(gd)
            launches = at_edge(read_counts())
            expect(launches, want, what)
            phases[what] = launches
            with plain_versions():
                ref = run(gd)
            compare(f"{what}: eval forward kernels vs plain", got[0], ref[0])
            compare(f"{what}: loss kernels vs plain", got[1].reshape(1),
                    ref[1].reshape(1))
            for k in ref[2]:
                compare(f"{what}: grad {k} kernels vs plain", got[2][k],
                        ref[2][k])
            evals[(name, tt)] = got[0]
            if name == "t48":
                # the BCSR without its transpose: K3 then K2 a layer
                fwd_only = gd._replace(aux=dataclasses.replace(
                    gd.aux, bsr=dataclasses.replace(gd.aux.bsr,
                                                    transpose=None)))
                model = model_().eval()
                with torch.inference_mode():
                    reset_counts()
                    outs = [model(fwd_only.x, fwd_only) for _ in range(2)]
                    torch.cuda.synchronize()
                    launches = at_edge(read_counts())
                what = f"edge{EDGE} serve gcn512 forward-only {tt}"
                expect(launches, at_edge({"K3": 4, ("K2bf" if tt == "bf16"
                                                    else "K2"): 4}), what)
                phases[what] = launches
                compare(f"{what} vs the threshold-48 operator", outs[0],
                        got[0])
                del model, outs, fwd_only
            del gd, got, ref
            torch.cuda.empty_cache()
    for name in ("t192diag", "group2"):
        compare(f"edge {EDGE} {name} eval forward vs t48's (f32)",
                evals[(name, "f32")], evals[("t48", "f32")])

    # the step's time on each f32 operator beside edge 128's, in one call
    step_ms("GCN hidden 512, K11 dropout 0.5", model_, device, (
        ("edge 128 (phase 3)", g),
        *((f"edge {EDGE} {k}", g._replace(aux=h)) for k, h in ops.items())))
    print(f"edge-{EDGE} steps: {time.perf_counter() - t_phase:.1f} s")
    return phases


# ---- phase 15: GAT's tiles of edge 256 -----------------------------------

# the bench graph's att_unit operators at edge 256 on phase 3's order and
# their split (live tiles, of which on the diagonal; stragglers; empty
# 128-wide quadrants of the live tiles).  At 128 the att_unit split equals
# the GCN split (phase 3), and at 256 it is phase 14's: threshold 48 is
# the CLI's default, 192 bench.py's rule at this edge, here collapsed onto
# clusters of 2,048.  The collapse pads the nodes to 169,984 = 664 x 256,
# which moves the pad node and its weight-0 edges (the JAX rule counts
# them toward a tile's threshold): 677 live tiles, 661 on the diagonal,
# where 169,472 rows give 678 and 662; every straggler collapses.
GAT_EDGE_OPS = {"t48": (1_174, 662, 225_132, 1_581),
                "t48bf": (1_174, 662, 225_132, 1_581),
                "t192c": (677, 661, 0, 490)}
GAT_EDGE_STEP = at_edge({k: STEP["GATConv"].get(k, 0)
                         + EVAL["GATConv"].get(k, 0)
                         for k in (*STEP["GATConv"], *EVAL["GATConv"])})
GAT_EDGE_MODES = {"default": {}, "exact": {"FITGNN_GAT_GLOBAL_MAX": "0"}}


def gat_block_operators(g, ds, order) -> dict:
    """GAT's operators at edge 256 on phase 3's node order: name →
    (graph with the operator attached, CPU tensors).  ``t48`` on phase 3's
    graph (presence weights, as ``build_optimized_graph`` weighs GAT's
    operator), ``t48bf`` its tiles in bf16, ``t192c`` threshold 192 under
    ``cluster_att=2048`` on the same order padded to a whole cluster;
    their split printed beside ``GAT_EDGE_OPS``'."""
    from fitgnn_tpu_torch.graph.build import build_graph
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

    t0 = time.perf_counter()

    def att(gr, **kw):
        s = gr.senders.numpy().astype(np.int64)
        r = gr.receivers.numpy().astype(np.int64)
        w = (gr.edge_weight.numpy() > 0).astype(np.float32)
        return build_hybrid(s, r, w, gr.num_nodes_padded, block=EDGE,
                            use_segmm=True, semantics="att_unit",
                            real_nodes=NUM_NODES, **kw)

    h48 = att(g, min_block_edges=48)
    inv = np.empty(NUM_NODES, dtype=np.int64)
    inv[order] = np.arange(NUM_NODES)
    gc = build_graph(ds.x[order], inv[ds.senders].astype(np.int32),
                     inv[ds.receivers].astype(np.int32), y=ds.y[order],
                     train_mask=ds.train_mask[order], node_pad_to=CLUSTER_K)
    check(gc.num_nodes_padded == CLUSTER_N_PAD,
          f"t192c: N_pad {gc.num_nodes_padded}")
    ops = {"t48": g._replace(aux=h48),
           "t48bf": g._replace(aux=bf16_tiles(h48)),
           "t192c": gc._replace(aux=att(gc, min_block_edges=192,
                                        cluster_att=CLUSTER_K))}
    print(f"GAT edge-{EDGE} ingest (3 operators): "
          f"{time.perf_counter() - t0:.1f} s")
    for name, gr in ops.items():
        h = gr.aux
        b = h.bsr
        check(b is not None and b.block == EDGE and h.dyn_plan is not None
              and b.blocks.shape[1:] == (EDGE, EDGE),
              f"GAT edge {EDGE} {name}: no {EDGE}-wide tile with a plan")
        quads = (b.blocks.reshape(-1, 2, 128, 2, 128) != 0).any(4).any(2)
        live = quads.flatten(1).any(1)
        tiles = int(live.sum())
        empty = int((~quads[live]).sum())
        on_diag = int((live & (b.rows == b.cols)).sum())
        stragglers = int((h.weights != 0).sum())
        cc = h.cluster_count
        collapsed = "" if cc is None else (
            f", {int((cc > 0).sum())} cluster entries ({cc.dtype}, "
            f"C {cc.shape[1]}, N_pad {gr.num_nodes_padded})")
        ref = GAT_EDGE_OPS[name]
        mib = b.blocks.numel() * b.blocks.element_size() / 2 ** 20
        print(f"GAT edge {EDGE} {name}: {tiles} live tiles ({on_diag} on "
              f"the diagonal; +{b.nnz_blocks - tiles} fillers), "
              f"{stragglers} stragglers{collapsed}; empty quadrants "
              f"{empty} of {4 * tiles} ({100 * empty / (4 * tiles):.1f}%); "
              f"tiles {b.blocks.dtype} {mib:.1f} MiB a direction; "
              f"expected (tiles, on the diagonal, stragglers, empty "
              f"quadrants) {ref}")
    return ops


def phase_gat_block_kernels(device, h) -> dict:
    """K4, K4ᵀ (on the transpose plan) and K5 at edge 256 on the
    threshold-48 operator's tiles (``dyn_kernel_rows``)."""
    t_phase = time.perf_counter()
    out = dyn_kernel_rows(device, h.to(device),
                          torch.Generator(device=device).manual_seed(15),
                          f"@{EDGE}")
    torch.cuda.empty_cache()
    print(f"GAT edge-{EDGE} kernels: {time.perf_counter() - t_phase:.1f} s")
    return out


def phase_gat_block_steps(device, g, ops) -> dict:
    """Through the library surface, every counter at 0 just before each
    counted run: on each operator at edge 256, under the default switches
    and under ``GLOBAL_MAX=0``, one GAT ``gc_train_step`` at hidden 512
    (bit dropout 0.5, seed-0 weights) and one eval forward, launching
    ``GAT_EDGE_STEP`` and held against the same run with the plain versions
    (the eval forward, the loss and every gradient); on the threshold-48
    operator, under PyTorch's deterministic algorithms, the step with the
    plan's ``live`` list (K5 on the live quadrants) against the step
    without it (the full grid), bit for bit; then the ``gc_train_step`` ms
    on each operator beside the edge-128 GAT operator's (phase 3's order
    at threshold 48), in one call."""
    from fitgnn_tpu_torch.models.models import NodeModel

    t_phase = time.perf_counter()
    phases = {}

    def model_():
        m = NodeModel("GATConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                      dropout_rate=0.5)
        return m.reset_parameters(torch.Generator().manual_seed(0)).to(
            device)

    def run(gd):
        return eval_and_step(model_(), gd, device)

    for name, gr in ops.items():
        gd = gr.to(device)
        for mode, env in GAT_EDGE_MODES.items():
            what = f"edge{EDGE} gat512 {name} {mode} step and eval"
            with switches(env):
                reset_counts()
                got = run(gd)
                launches = at_edge(read_counts())
                expect(launches, GAT_EDGE_STEP, what)
                phases[what] = launches
                with plain_versions():
                    ref = run(gd)
            compare(f"{what}: eval forward kernels vs plain", got[0], ref[0])
            compare(f"{what}: loss kernels vs plain", got[1].reshape(1),
                    ref[1].reshape(1))
            for k in ref[2]:
                compare(f"{what}: grad {k} kernels vs plain", got[2][k],
                        ref[2][k])
            del got, ref
        if name == "t48":
            # K5 on the live list gives the step the full grid gives
            plan = gd.aux.dyn_plan
            check(plan.live is not None, "t48: the plan has no live list")
            full = gd._replace(aux=dataclasses.replace(
                gd.aux, dyn_plan=dataclasses.replace(plan, live=None)))
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                a, b_, c = (run(gr) for gr in (gd, full, gd))
            finally:
                torch.use_deterministic_algorithms(False)
            for other, what in ((b_, "without the live list"),
                                (c, "twice")):
                check(torch.equal(a[1], other[1]) and all(
                    torch.equal(a[2][k], other[2][k]) for k in a[2]),
                    f"edge{EDGE} gat512 t48 step {what}: not bit for bit "
                    "the step with the live list")
            print(f"edge{EDGE} gat512 t48 step: loss and {len(a[2])} "
                  "gradients bit for bit with and without the plan's live "
                  "list (deterministic algorithms)")
            del a, b_, c, full
        del gd
        torch.cuda.empty_cache()

    # the step's time on each operator beside edge 128's, in one call
    step_ms("GAT hidden 512, dropout 0.5", model_, device, (
        ("edge 128 t48", att_unit_128(g)),
        *((f"edge {EDGE} {k}", v) for k, v in ops.items())))
    print(f"GAT edge-{EDGE} steps: {time.perf_counter() - t_phase:.1f} s")
    return phases


def att_unit_128(g):
    """Phase 3's graph with its ``att_unit`` operator at edge 128 and
    threshold 48, the yardstick of the steps at 256."""
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

    s = g.senders.numpy().astype(np.int64)
    r = g.receivers.numpy().astype(np.int64)
    w = (g.edge_weight.numpy() > 0).astype(np.float32)
    return g._replace(aux=build_hybrid(s, r, w, g.num_nodes_padded,
                                       min_block_edges=48, use_segmm=True,
                                       semantics="att_unit"))


# ---- phase 16: GAT's fused tile attention at edge 256 ---------------------

# phase 16's fused steps on each operator at 256: phase 4's two fused modes
# on the threshold-48 masks, phase 12's exact fused mode on the collapsed
# operator, each launching its counts at 128 under the @256 IDs
FUSED_EDGE_MODES = {"t48": ("GATConv fused", "GATConv fused exact"),
                    "t48bf": ("GATConv fused", "GATConv fused exact"),
                    "t192c": ("GATConv fused den exact",)}


def k7_edge_rows(device, h, tt, gen) -> dict:
    """K7rm, K7f, K7bt's dx walk, the score pass K7s and its sums K7sums on
    the tiles of ``h`` (an ``att_unit`` operator at edge 256; ``tt`` "f32"
    or "bf16", the mask's type) at F=128 and 512, each against its plain
    version (K7rm bit for bit; the pass's partials too; two launches of
    K7s + K7sums bit-equal; a bf16 form bit for bit its f32 form on the
    mask widened), with kernel, plain and two-stage times and its bound,
    and the fused outputs and gradients against the two-stage path at the
    same edge (``pe``, K4@256 and row sums; its autograd backward through
    K5@256 and K4ᵀ@256).  The plan carries the mask's occupancy words
    (checked against the mask, ``live`` against the words): K7f walks the
    live quadrants and K7s runs its live grid, each also bit for bit the
    launch without them (timed beside it, ``nowords_ms``), with its bound
    over the live quadrants and the tile bound beside it
    (``bound_tiles_ms``; K7s also its dense TF32 product over the live
    quadrants); K7bt's ``dx`` walks the live quadrants of the plan's
    ``t_words`` likewise, and K7sums reads the partials of the live
    quadrants of ``words`` and ``t_words`` alone (on each mask's pass,
    against its plain version and bit for bit the launch without them;
    its row's ``bound_ms`` over the live partials).  Returns the rows by
    ID (``K7f@256``, ``K7fbf@256``, ...; K7sums, which reads no tile,
    from the f32 mask)."""
    from fitgnn_tpu_torch.ops import att_bsr
    from fitgnn_tpu_torch.ops.bsr_dynamic import live_quadrants as live_ids
    from fitgnn_tpu_torch.ops.tile_gat import tiles_two_stage

    hd = h.to(device)
    b, plan = hd.bsr, hd.dyn_plan
    rows, cols, blocks = b.rows, b.cols, b.blocks
    b32 = blocks.float()
    bf16 = tt == "bf16"
    n, e = hd.num_nodes, b.block
    nb, nq, k_all = n // e, e // 128, b.nnz_blocks
    nnz = int((blocks != 0).sum())
    uniq_cols = int(torch.unique(cols).numel())
    uniq_rows = int(torch.unique(rows).numel())
    # the live quadrants of the plan's words, the distinct 128-row slabs
    # they reach (x by column, g by row) and the walk and grid without them
    quads, c_slabs, r_slabs = dyn_live_quadrants(b, plan)
    check(torch.equal(plan.live.cpu().long(), torch.from_numpy(
        live_ids(plan.words.cpu().numpy(), nq))),
        "the plan's live quadrants are not its words' set bits")
    nowords = dataclasses.replace(plan, words=None, t_words=None, live=None)
    print(f"K7f{'bf' if bf16 else ''}@{EDGE}, K7s: {quads} live 128-wide "
          f"quadrants of {k_all * nq * nq}; {c_slabs} / {r_slabs} distinct "
          "x / g slabs they reach")
    ssrc, sdst, dden = (torch.randn(n, generator=gen, device=device)
                        for _ in range(3))
    mg = (sdst + ssrc.max()).clamp_min(0.0)
    vec = n * 4
    elt = blocks.element_size()
    tile_bytes = k_all * e * e * elt
    quad_bytes = quads * 128 * 128 * elt
    idx_f = (k_all + nb + 1) * 4
    idx_t = (3 * plan.t_sel.numel() + nb + 1) * 4
    part_bytes = 2 * k_all * nq * e * 4               # (K, nq·E) twice
    sfx = "bf" if bf16 else ""
    out = {f"{k}{sfx}@{EDGE}": [] for k in ("K7rm", "K7f", "K7bt", "K7s")}
    if not bf16:
        out[f"K7sums@{EDGE}"] = []
    fwd = (rows, cols, plan, blocks, ssrc, sdst)
    fwd32 = (rows, cols, plan, b32, ssrc, sdst)
    fwd0 = (rows, cols, nowords, blocks, ssrc, sdst)
    two_bwd_label = (f"the two-stage autograd backward at {EDGE} for dssrc, "
                     f"dsdst and dx (K5@{EDGE}, K4T@{EDGE}, the elementwise "
                     "chain): compare with K7bt + K7s + K7sums")
    two_scores_label = (f"the two-stage autograd backward at {EDGE} for "
                        f"dssrc and dsdst (K5@{EDGE}, the elementwise "
                        "chain): compare with K7s + K7sums")

    def same(name, got, f32):
        if bf16:
            check(all(torch.equal(a, c) for a, c in zip(got, f32)),
                  f"{name}: the bf16 form differs from the f32 form")

    def bits(name, got, without):
        check(all(torch.equal(a, c) for a, c in zip(got, without)),
              f"{name}: with the occupancy words not the launch without "
              "them bit for bit")

    def errs(es):
        return dict(max_abs_err=max(x["max_abs_err"] for x in es),
                    max_rel_err=max(x["max_rel_err"] for x in es))

    def add(k, sh):
        out[f"{k}{sfx}@{EDGE}"].append(sh)
        two = sh.get("two_stage_ms")
        print(f"  {k}{sfx}@{EDGE} {sh['shape']}: kernel_ms={sh['ms']:.4f} "
              + (f"nowords_ms={sh['nowords_ms']:.4f} "
                 if "nowords_ms" in sh else "")
              + f"plain_ms={sh['plain_ms']:.4f} library_ms=null "
              f"two_stage_ms={'null' if two is None else f'{two:.4f}'} "
              f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']})"
              + (f" bound_tiles_ms={sh['bound_tiles_ms']:.4f}"
                 if "bound_tiles_ms" in sh else ""))

    print(f"GAT fused tiles at edge {EDGE}, {tt} mask: {k_all} tiles "
          f"(fillers included), {nnz} mask entries")
    with torch.inference_mode():
        rm = att_bsr.att_rowmax(*fwd, SLOPE)
        rp = att_bsr.att_rowmax_plain(*fwd, SLOPE)
        same(f"K7rm{sfx}@{EDGE}", (rm,), (att_bsr.att_rowmax(*fwd32, SLOPE),))
        torch.cuda.synchronize()
        check(torch.equal(rm, rp), f"K7rm{sfx}@{EDGE}: differs from its "
              "plain version")
        print(f"  K7rm{sfx}@{EDGE}: bit for bit its plain version, "
              f"{int((rm <= -1e29).sum())} rows without a tile entry")
        brm, byrm = bound(tile_bytes + idx_f + 3 * vec, 3.0 * nnz)
        plain_rm = cuda_ms(lambda: att_bsr.att_rowmax_plain(*fwd, SLOPE), 5)
        add("K7rm", dict(
            F=None, shape="rows", max_abs_err=0.0, max_rel_err=0.0,
            bit_exact=True, bound_ms=brm, bound_by=byrm,
            ms=cuda_ms(lambda: att_bsr.att_rowmax(*fwd, SLOPE), 20),
            plain_ms=plain_rm, library_ms=None, two_stage_ms=plain_rm,
            two_stage_label="the materialised tile row max (its plain "
                            "version)"))
        del rm, rp
    for feat in (NUM_FEATURES, HIDDEN):
        # at F=128 (layer 0, raw features) the backward needs no dx
        need_dx = feat == HIDDEN
        x = torch.randn((n, feat), generator=gen, device=device)
        gr = torch.randn((n, feat), generator=gen, device=device)
        bwd = (plan, blocks, ssrc, sdst, mg, gr, x, dden, SLOPE)
        bwd0 = (nowords, *bwd[1:])
        tag = f"{sfx}@{EDGE}"

        def dx_walk(bl, words=plan.t_words):
            return att_bsr._launch_walk(
                "att_bwd_t (dx)", device, bl, plan.t_row_splits, plan.t_sel,
                plan.t_scale, plan.t_cols, words, ssrc, sdst, mg, gr, None,
                True, SLOPE)

        def scores(bl, live=plan.live):
            return att_bsr._launch_scores(
                "att_bwd_scores", device, bl, rows, cols, live, ssrc, sdst,
                mg, gr, x, dden, SLOPE)

        with torch.inference_mode():
            num, den = att_bsr.att_fwd(*fwd, mg, x, SLOPE)
            same(f"K7f{tag} F={feat}", (num, den),
                 att_bsr.att_fwd(*fwd32, mg, x, SLOPE))
            bits(f"K7f{tag} F={feat}", (num, den),
                 att_bsr.att_fwd(*fwd0, mg, x, SLOPE))
            num_p, den_p = att_bsr.att_fwd_plain(*fwd, mg, x, SLOPE)
            e_f = [compare(f"K7f{tag} att_fwd {w} F={feat}", a, p_)
                   for w, a, p_ in (("num", num, num_p), ("den", den, den_p))]
            del num_p, den_p
            dx = dx_walk(blocks)
            same(f"K7bt{tag} F={feat}", (dx,), (dx_walk(b32),))
            bits(f"K7bt{tag} F={feat}", (dx,), (dx_walk(blocks, None),))
            e_t = compare(f"K7bt{tag} att_bwd_t dx F={feat}", dx,
                          att_bsr.att_bwd_t_plain(*bwd, need_dssrc=False)[0])
            part = scores(blocks)
            same(f"K7s{tag} F={feat}", part, scores(b32))
            bits(f"K7s{tag} F={feat}", part, scores(blocks, None))
            part_p = att_bsr.att_scores_plain(rows, cols, *bwd)
            check(part[0].shape == (k_all, nq * e),
                  f"K7s{tag}: partials {tuple(part[0].shape)}")
            e_p = [compare(f"K7s{tag} pass {w} partials F={feat}", a, p_)
                   for w, a, p_ in zip(("column", "row"), part, part_p)]
            dss, dsd = att_bsr.att_bwd_scores(rows, cols, *bwd)
            again = att_bsr.att_bwd_scores(rows, cols, *bwd)
            pair = f"K7s{tag} + K7sums@{EDGE} F={feat}"
            check(torch.equal(dss, again[0]) and torch.equal(dsd, again[1]),
                  f"{pair}: two launches differ")
            bits(pair, (dss, dsd), att_bsr.att_bwd_scores(rows, cols, *bwd0))
            print(f"  {pair}: two launches bit-equal, and bit for bit the "
                  "pass over every quadrant; K7f and K7bt likewise the walk "
                  "without words")
            e_s = [compare(f"K7s{tag} att_bwd_scores {w} F={feat}", a, p_)
                   for w, a, p_ in zip(("dssrc", "dsdst"), (dss, dsd),
                                       att_bsr.att_bwd_scores_plain(
                                           rows, cols, *bwd))]
            e_c = [compare(f"K7sums{tag} att_sums {w} F={feat}", a, p_)
                   for w, a, p_ in zip(("dssrc", "dsdst"),
                                       att_bsr.att_sums(plan, *part_p),
                                       att_bsr.att_sums_plain(plan,
                                                              *part_p))]
            # K7sums with the plan's words reads the live quadrants'
            # partials of the pass alone
            sums = att_bsr.att_sums(plan, *part)
            bits(f"K7sums{tag} F={feat}", sums,
                 att_bsr.att_sums(nowords, *part))
            e_c += [compare(f"K7sums{tag} att_sums {w} words F={feat}", a,
                            p_)
                    for w, a, p_ in zip(("dssrc", "dsdst"), sums,
                                        att_bsr.att_sums_plain(plan, *part))]
            print(f"  K7sums{tag} F={feat}: with the words within tolerance "
                  "of its plain version and bit for bit the launch without "
                  "them, on the pass's partials")
            del part_p, again, sums
        # the two-stage path at the same edge must agree, forward and in
        # the gradients
        ss_, sd_ = ssrc.clone().requires_grad_(), sdst.clone().requires_grad_()
        x_ = x.clone().requires_grad_(need_dx)
        num2, den2 = tiles_two_stage(SLOPE, rows, cols, plan, blocks, ss_,
                                     sd_, mg, x_)
        inputs = (ss_, sd_, x_) if need_dx else (ss_, sd_)
        grads2 = torch.autograd.grad((num2, den2), inputs, (gr, dden),
                                     retain_graph=True)
        compare(f"K7f{tag} num vs two-stage F={feat}", num, num2.detach())
        compare(f"K7f{tag} den vs two-stage F={feat}", den, den2.detach())
        compare(f"K7s{tag} dssrc vs two-stage F={feat}", dss, grads2[0])
        compare(f"K7s{tag} dsdst vs two-stage F={feat}", dsd, grads2[1])
        if need_dx:
            compare(f"K7bt{tag} dx vs two-stage F={feat}", dx, grads2[2])
        two_bwd = cuda_ms(lambda: torch.autograd.grad(
            (num2, den2), inputs, (gr, dden), retain_graph=True), 5)
        two_scores = cuda_ms(lambda: torch.autograd.grad(
            (num2, den2), (ss_, sd_), (gr, dden), retain_graph=True), 5)
        del num2, den2, grads2, num, den, dx, dss, dsd
        with torch.inference_mode():
            slabs = e * feat * 4
            qslab = 128 * feat * 4
            # the bounds of phase 3's rows with 256-wide tiles and slabs,
            # the partials (K, nq·E) each; over the live quadrants: each
            # live quadrant read once, the words (K7f) or the live list
            # (K7s) and the distinct 128-row slabs the live quadrants
            # reach, the tile bounds beside them
            f_ops = nnz * (2.0 * feat + 5)
            bf_t, _ = bound(tile_bytes + idx_f + 3 * vec + uniq_cols * slabs
                            + n * feat * 4 + vec, f_ops)
            bf_, byf = bound(quad_bytes + idx_f + k_all * 8 + 3 * vec
                             + c_slabs * qslab + n * feat * 4 + vec, f_ops)
            bdx_t, _ = bound(tile_bytes + idx_t + 3 * vec
                             + uniq_rows * slabs + n * feat * 4,
                             nnz * (2.0 * feat + 5))
            kt = plan.t_sel.numel()
            bdx, bydx = bound(quad_bytes + idx_t + kt * 8 + 3 * vec
                              + r_slabs * qslab + n * feat * 4,
                              nnz * (2.0 * feat + 5))
            s_ops = nnz * (2.0 * feat + 8)
            bs_t, _ = bound(tile_bytes + 2 * k_all * 4 + 4 * vec
                            + (uniq_rows + uniq_cols) * slabs + part_bytes,
                            s_ops)
            bs, bys = bound(quad_bytes + 2 * k_all * 4 + quads * 4 + 4 * vec
                            + (r_slabs + c_slabs) * qslab + part_bytes,
                            s_ops)
            bs_tc = 3 * 2.0 * k_all * e * e * feat \
                / PEAK_TF32_FLOP_PER_S * 1e3
            bs_tc_live = 3 * 2.0 * quads * 128 * 128 * feat \
                / PEAK_TF32_FLOP_PER_S * 1e3
            bc_t, _ = bound(part_bytes + idx_t + (nb + 1) * 4 + 2 * vec,
                            2.0 * k_all * nq * e)
            # with the words: each live quadrant's row and column partial
            # (1 KiB), the slots' words
            bc, byc = bound(quads * 2 * 128 * 4 + idx_t + (nb + 1) * 4
                            + (k_all + kt) * 8 + 2 * vec, 2.0 * quads * 128)
            add("K7f", dict(
                F=feat, shape=f"F={feat}", **errs(e_f), bound_ms=bf_,
                bound_by=byf, bound_tiles_ms=bf_t, live_quadrants=quads,
                ms=cuda_ms(lambda: att_bsr.att_fwd(*fwd, mg, x, SLOPE), 20),
                nowords_ms=cuda_ms(lambda: att_bsr.att_fwd(
                    *fwd0, mg, x, SLOPE), 20),
                plain_ms=cuda_ms(lambda: att_bsr.att_fwd_plain(
                    *fwd, mg, x, SLOPE), 5), library_ms=None,
                two_stage_ms=cuda_ms(lambda: tiles_two_stage(
                    SLOPE, rows, cols, plan, blocks, ssrc, sdst, mg, x), 10),
                two_stage_label=f"materialised pe, K4@{EDGE} and the den "
                                "row sums"))
            # the path launches the dx walk at F=512 only (layer 1)
            add("K7bt", dict(
                F=feat, shape=f"F={feat}", launch="dx", on_path=need_dx,
                **e_t, bound_ms=bdx, bound_by=bydx, bound_tiles_ms=bdx_t,
                live_quadrants=quads,
                ms=cuda_ms(lambda: dx_walk(blocks), 20),
                nowords_ms=cuda_ms(lambda: dx_walk(blocks, None), 20),
                plain_ms=cuda_ms(lambda: att_bsr.att_bwd_t_plain(
                    *bwd, need_dssrc=False), 5), library_ms=None,
                two_stage_ms=two_bwd if need_dx else None,
                two_stage_label=two_bwd_label))
            both = cuda_ms(lambda: att_bsr.att_bwd_scores(rows, cols, *bwd),
                           20)
            add("K7s", dict(
                F=feat, shape=f"F={feat}", **errs(e_s + e_p), bound_ms=bs,
                bound_by=bys, bound_tiles_ms=bs_t, live_quadrants=quads,
                bound_tensor_cores_ms=bs_tc,
                bound_tensor_cores_live_ms=bs_tc_live,
                ms=cuda_ms(lambda: scores(blocks), 20),
                nowords_ms=cuda_ms(lambda: scores(blocks, None), 20),
                plain_ms=cuda_ms(lambda: att_bsr.att_scores_plain(
                    rows, cols, *bwd), 5), library_ms=None,
                both_outputs_ms=both, two_stage_ms=two_scores,
                two_stage_label=two_scores_label))
            print(f"  K7s{tag} + K7sums@{EDGE} F={feat}: both outputs "
                  f"{both:.4f} ms; the pass's dense product at the TF32 "
                  f"rate {bs_tc_live:.4f} ms over the live quadrants, "
                  f"{bs_tc:.4f} over every quadrant")
            if not bf16:
                # a few microseconds, under the wrapper's host work: ms is
                # the device time, wrapper_ms cuda_ms's
                add("K7sums", dict(
                    F=feat, shape=f"F={feat}", **errs(e_c), bound_ms=bc,
                    bound_by=byc, bound_tiles_ms=bc_t, live_quadrants=quads,
                    ms=device_ms(lambda: att_bsr.att_sums(plan, *part), 20),
                    nowords_ms=device_ms(lambda: att_bsr.att_sums(
                        nowords, *part), 20),
                    wrapper_ms=cuda_ms(lambda: att_bsr.att_sums(plan, *part),
                                       20),
                    plain_ms=cuda_ms(lambda: att_bsr.att_sums_plain(
                        plan, *part), 20), library_ms=None,
                    two_stage_ms=None, two_stage_label=two_scores_label))
        del x, gr, x_, ss_, sd_, part
        torch.cuda.empty_cache()
    del hd, b32
    return out


def phase_gat_fused_block_kernels(device, ops) -> dict:
    """``k7_edge_rows`` on the threshold-48 operator's f32 and bf16
    masks."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(16)
    out = {}
    for name, tt in (("t48", "f32"), ("t48bf", "bf16")):
        out.update(k7_edge_rows(device, ops[name].aux, tt, gen))
        torch.cuda.empty_cache()
    print(f"GAT fused edge-{EDGE} kernels: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


def phase_gat_fused_block_steps(device, g, ops) -> dict:
    """Through the library surface, every counter at 0 just before each
    counted run: on each operator at edge 256 under its ``FUSED_EDGE_MODES``
    one fused GAT ``gc_train_step`` at hidden 512 (bit dropout 0.5, seed-0
    weights) and one eval forward, launching the same mode's counts at 128
    (``STEP``, ``EVAL``; the tile kernels under their ``@256`` IDs, in
    their bf16 forms on the bf16 mask) and held against the same run with
    the plain versions (the eval forward, the loss and every gradient);
    then the ``gc_train_step`` ms under ``FUSED`` on each operator beside
    the edge-128 GAT operator's, in one call."""
    from fitgnn_tpu_torch.models.models import NodeModel

    t_phase = time.perf_counter()
    phases = {}

    def model_():
        m = NodeModel("GATConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                      dropout_rate=0.5)
        return m.reset_parameters(torch.Generator().manual_seed(0)).to(
            device)

    def run(gd):
        return eval_and_step(model_(), gd, device)

    for name, modes in FUSED_EDGE_MODES.items():
        gd = ops[name].to(device)
        for mode in modes:
            want = {k: STEP[mode].get(k, 0) + EVAL[mode].get(k, 0)
                    for k in (*STEP[mode], *EVAL[mode])}
            want = at_edge(bf16_counts(want) if name == "t48bf" else want)
            what = f"edge{EDGE} gat512 {name} {mode} step and eval"
            with switches(MODE_ENV[mode]):
                reset_counts()
                got = run(gd)
                launches = at_edge(read_counts())
                expect(launches, want, what)
                phases[what] = launches
                with plain_versions():
                    ref = run(gd)
            compare(f"{what}: eval forward kernels vs plain", got[0], ref[0])
            compare(f"{what}: loss kernels vs plain", got[1].reshape(1),
                    ref[1].reshape(1))
            for k in ref[2]:
                compare(f"{what}: grad {k} kernels vs plain", got[2][k],
                        ref[2][k])
            del got, ref
        del gd
        torch.cuda.empty_cache()

    # the fused step's time on each operator beside edge 128's, in one call
    with switches(FUSED):
        step_ms("GAT fused + SEGMM_DEN hidden 512, dropout 0.5", model_,
                device, (("edge 128 t48", att_unit_128(g)),
                         *((f"edge {EDGE} {k}", v) for k, v in ops.items())))
    print(f"GAT fused edge-{EDGE} steps: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return phases


# ---- phase 17: the memory, stats and save-graphs subcommands ---------------

def read_rows(path: str, header: str) -> list:
    """The rows of a results CSV the CLI appended to, by column name; the
    header must be the JAX package's."""
    with open(path) as f:
        lines = f.read().splitlines()
    check(lines[0] == header, f"{path}: header {lines[0]!r}")
    return [dict(zip(header.split(","), line.split(",")))
            for line in lines[1:]]


def phase_tools_node(tmp, g) -> tuple:
    """``stats``, then ``save-graphs`` and ``memory`` on the bench graph
    with phase 9's partition flags (``--extra_node --bucket_sizes``;
    neither subcommand takes ``--hidden``), through the port's CLI on
    ``cuda`` with every counter at 0 just before each: no launch;
    ``save-graphs`` computes the partition (counted) into the port's
    cache, ``memory`` loads it (no partition) and holds the full graph and
    the largest subgraph on the card, and its rows are the byte accounting
    of the partition ``save-graphs`` made.  Returns (the partition's host
    seconds, the partition), which phase 9's ``train`` runs then load from
    the cache."""
    from fitgnn_tpu_torch.bench.memory import graph_bytes
    from fitgnn_tpu_torch.data.stats import DatasetStats
    from fitgnn_tpu_torch.partition import pipeline
    from fitgnn_tpu_torch.utils.results import MEMORY_HEADER

    t_phase = time.perf_counter()
    seen = []
    partition = pipeline.coarsen_and_partition

    def timed_partition(*args, **kwargs):
        t0 = time.perf_counter()
        part = partition(*args, **kwargs)
        seen.append((time.perf_counter() - t0, part))
        return part

    flags = ["--extra_node", "--bucket_sizes"]
    with mock.patch.object(pipeline, "coarsen_and_partition",
                           timed_partition):
        launches, _, wall = run_cli(tmp, ["stats"])
        expect(launches, {}, "tools stats")
        row = read_rows(os.path.join(tmp, "dataset_info.csv"),
                        DatasetStats.CSV_HEADER)[-1]
        check(row["num_nodes"] == str(NUM_NODES)
              and row["num_features"] == str(NUM_FEATURES)
              and row["num_classes"] == str(NUM_CLASSES)
              and all(0.0 <= float(row[k]) <= 1.0 for k in (
                  "homophily_edge", "homophily_node",
                  "homophily_edge_insensitive")), f"stats row {row}")
        print(f"tools stats: {wall:.1f} s; dataset_info.csv row {row}")
        launches, _, wall = run_cli(tmp, ["save-graphs", *flags])
        expect(launches, {}, "tools save-graphs")
        check(len(seen) == 1, f"save-graphs partitioned {len(seen)} times")
        secs, part = seen[0]
        print(f"tools save-graphs: {wall:.1f} s, the partition {secs:.2f} s "
              "host, into the port's cache")
        torch.cuda.reset_peak_memory_stats()
        launches, _, wall = run_cli(tmp, ["memory", *flags])
        expect(launches, {}, "tools memory")
        check(len(seen) == 1, "memory partitioned: save-graphs left the "
              "cache cold")
    rows = read_rows(os.path.join(tmp, "memory_usage.csv"), MEMORY_HEADER)
    check([r["Type"] for r in rows] == ["full_graph:extra_node",
                                        "max_subgraph:extra_node"],
          f"memory rows {rows}")
    # the rows from the partition save-graphs made: the graph's real
    # payload (phase 3's graph: the same edges in another node order), and
    # the largest subgraph's across the buckets
    full = graph_bytes(int(g.n_node), int(g.n_edge), NUM_FEATURES)
    sub = max(graph_bytes(int(n), int(e), NUM_FEATURES)
              for b in part.subgraphs
              for n, e in zip(b.n_node.tolist(), b.n_edge.tolist()))
    for r_, want in zip(rows, (full, sub)):
        check(r_["Max_Memory_Usage_Graphs(MB)"]
              == f"{want / (1024 * 1024):.2f}", f"memory row {r_}, "
              f"expected {want / (1024 * 1024):.2f} MB")
    print(f"tools memory: {wall:.1f} s, from the cache; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; rows "
          + "; ".join(f"{r_['Type']} {r_['Max_Memory_Usage_Graphs(MB)']} MB"
                      for r_ in rows))
    print(f"tools phase (node): {time.perf_counter() - t_phase:.1f} s")
    return secs, part


def phase_tools_graph(tmp) -> None:
    """``memory --task graph_cls --extra_node`` on phase 13's 2,048
    molecules through the port's CLI on ``cuda``, no launch: the first
    chunk of 128 molecules in the Gs and the Gc view held on the card and
    the largest molecule, three rows (MB of 10^6 bytes, as the JAX
    package's); the largest molecule's row checked against the dataset's
    arrays, the chunks' above 0."""
    from fitgnn_tpu_torch.data.datasets import load_graph_dataset
    from fitgnn_tpu_torch.utils.results import MEMORY_HEADER

    t_phase = time.perf_counter()
    launches, _, wall = run_cli(tmp, ["memory", "--task", "graph_cls",
                                      "--extra_node"], dataset="qm9proxycls")
    expect(launches, {}, "tools memory graph_cls")
    rows = read_rows(os.path.join(tmp, "memory_usage.csv"),
                     MEMORY_HEADER)[-3:]
    check([r["Type"] for r in rows] == [
        "chunk_gs:extra_node", "chunk_gc:extra_node",
        "max_graph:extra_node"], f"graph memory rows {rows}")
    gds = load_graph_dataset("qm9proxycls", os.path.join(tmp, "dataset"))
    big = max(gds.graphs, key=lambda g: g[0].shape[0])
    want = f"{sum(a.nbytes for a in big) / 1e6:.2f}"
    # a molecule's few KB print as 0.00 MB, as in the JAX package
    check(rows[2]["Max_Memory_Usage_Graphs(MB)"] == want
          and all(float(r["Max_Memory_Usage_Graphs(MB)"]) > 0
                  for r in rows[:2]),
          f"graph memory rows {rows}, max_graph expected {want}")
    print(f"tools memory graph_cls: {wall:.1f} s; rows " + "; ".join(
        f"{r['Type']} {r['Max_Memory_Usage_Graphs(MB)']} MB" for r in rows))
    print(f"tools phase (graph): {time.perf_counter() - t_phase:.1f} s")


# ---- phase 18: GAT's tile opt-ins and diagnostic switches ------------------

# GAT's opt-in operators on phase 3's order at threshold 48 (the CLI's):
# (edge, build_hybrid's opt-ins, bf16 mask, the modes of STEP / EVAL /
# MODE_ENV each steps under)
GAT_OPTIN_OPS = {
    "diag128": (128, dict(use_diag=True), False,
                ("GATConv", "GATConv fused", "GATConv fused exact")),
    "diag128bf": (128, dict(use_diag=True), True,
                  ("GATConv", "GATConv fused exact")),
    "diag256": (EDGE, dict(use_diag=True), False,
                ("GATConv", "GATConv fused", "GATConv fused exact")),
    "diag256bf": (EDGE, dict(use_diag=True), True, ("GATConv fused",)),
    "group128": (128, dict(tile_group=2), False,
                 ("GATConv", "GATConv fused")),
    "group256": (EDGE, dict(tile_group=2), False,
                 ("GATConv", "GATConv fused exact")),
    "rowwalk128": (128, dict(use_rowwalk=True), False,
                   ("GATConv", "GATConv fused", "GATConv fused exact"))}
# the modes held bit for bit with and without the plan's occupancy words
GAT_OPTIN_WORDS_MODES = ("GATConv", "GATConv fused exact")
# the diagnostic switches, each stepped on the default operator (edge 128,
# threshold 48) with the default path's launches, and the straggler
# primitives of ops/tile_gat.py each must run
GAT_SWITCHES = {
    "fused_bwd": ({"FITGNN_GAT_FUSED_BWD": "1"},
                  {"_StragglerAttentionFused"}),
    "fused_bwd_sorted_dh": ({"FITGNN_GAT_FUSED_BWD": "1",
                             "FITGNN_GAT_FUSED_SORTED_DH": "1"},
                            {"_StragglerAttentionFused"}),
    "sorted_num_src": ({"FITGNN_GAT_SORTED_NUM": "1",
                        "FITGNN_GAT_SORTED_SRC": "1"},
                       {"_WeightedSpmmSorted", "_GatherSenders"})}


def gat_optin_want(name: str, mode: str) -> dict:
    """The launches of one step and one eval forward of ``mode`` on the
    opt-in operator ``name``: the mode's counts at 128 (phase 4), under the
    ``@256`` IDs at 256 and in their bf16 forms on a bf16 mask; on the row
    walk (no plan: the einsum branch, never fused) the straggler kernels'
    alone."""
    edge, kw, bf16, _ = GAT_OPTIN_OPS[name]
    want = {k: STEP[mode].get(k, 0) + EVAL[mode].get(k, 0)
            for k in (*STEP[mode], *EVAL[mode])}
    if kw.get("use_rowwalk"):
        want = {k: v for k, v in want.items() if k in ("K3w", "K6")}
    if bf16:
        want = bf16_counts(want)
    return at_edge(want) if edge == EDGE else want


def gat_optin_operators(g) -> dict:
    """GAT's opt-in operators (``GAT_OPTIN_OPS``) on phase 3's graph, as
    ``build_optimized_graph`` weighs GAT's operator (presence): name →
    the graph with the operator attached, CPU tensors; a bf16 mask is the
    f32 operator's cast (``bf16_tiles``).  Checks each one's structure:
    no live diagonal tile in the BCSR beside diagonal blocks, every block
    row's run a multiple of 2 under ``tile_group=2``, no plan on the row
    walk and one elsewhere, and at 256 the plan's occupancy words (and
    their transposes and live list) those of the BCSR's own tiles, word 0
    on every pad and filler."""
    from fitgnn_tpu_torch.ops.bsr_dynamic import live_quadrants as live_ids
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

    t0 = time.perf_counter()
    s = g.senders.numpy().astype(np.int64)
    r = g.receivers.numpy().astype(np.int64)
    w = (g.edge_weight.numpy() > 0).astype(np.float32)
    built, ops = {}, {}
    for name, (edge, kw, bf16, _) in GAT_OPTIN_OPS.items():
        key = (edge, tuple(kw.items()))
        if key not in built:
            built[key] = build_hybrid(
                s, r, w, g.num_nodes_padded, min_block_edges=48, block=edge,
                use_segmm=True, semantics="att_unit", real_nodes=NUM_NODES,
                **kw)
        h = built[key]
        ops[name] = g._replace(aux=bf16_tiles(h) if bf16 else h)
    print(f"GAT opt-in ingest ({len(built)} operators): "
          f"{time.perf_counter() - t0:.1f} s")
    for name, gr in ops.items():
        edge, kw, _, _ = GAT_OPTIN_OPS[name]
        h = gr.aux
        b, plan = h.bsr, h.dyn_plan
        check(b is not None and b.block == edge,
              f"GAT opt-in {name}: no {edge}-wide tile")
        live = b.blocks.flatten(1).any(1)
        on_diag = int((live & (b.rows == b.cols)).sum())
        nd = 0 if h.diag_blocks is None else int(
            h.diag_blocks.flatten(1).any(1).sum())
        check((h.diag_blocks is not None) == bool(kw.get("use_diag"))
              and (on_diag == 0 or h.diag_blocks is None),
              f"GAT opt-in {name}: {nd} diagonal blocks, {on_diag} live "
              "diagonal tiles in the BCSR")
        if kw.get("tile_group"):
            runs = torch.bincount(b.rows.long(), minlength=b.num_row_blocks)
            check(b.group == 2 and bool((runs % 2 == 0).all()),
                  f"GAT opt-in {name}: a block row's run is not even")
        check((plan is None) == bool(kw.get("use_rowwalk")),
              f"GAT opt-in {name}: a plan where the JAX package builds "
              "none, or none where it builds one")
        words = ""
        if plan is not None and edge == EDGE:
            quads, _, _ = dyn_live_quadrants(b, plan)
            check(bool((plan.words[~live] == 0).all())
                  and torch.equal(plan.live.long(), torch.from_numpy(
                      live_ids(plan.words.numpy(), edge // 128))),
                  f"GAT opt-in {name}: the plan's words or live list do "
                  "not follow its tiles")
            words = (f"; plan words: {quads} live quadrants of "
                     f"{4 * b.nnz_blocks}, word 0 on the "
                     f"{int((~live).sum())} empty tiles")
        print(f"GAT opt-in {name} (edge {edge}, {b.blocks.dtype}): "
              f"{int(live.sum())} live tiles of {b.nnz_blocks} "
              f"({on_diag} on the diagonal), {nd} live diagonal blocks, "
              f"{int((h.weights != 0).sum())} stragglers, "
              f"{'a plan' if plan is not None else 'no plan'}{words}")
    return ops


@contextlib.contextmanager
def straggler_branches():
    """The straggler primitives of ``ops/tile_gat.py`` that the calls in
    the block apply: a set of their class names."""
    from fitgnn_tpu_torch.ops import tile_gat

    used = set()

    def proxy(name):
        cls = getattr(tile_gat, name)

        class Counted:
            @staticmethod
            def apply(*args):
                used.add(name)
                return cls.apply(*args)
        return Counted

    with contextlib.ExitStack() as stack:
        for name in ("_StragglerAttentionFused", "_WeightedSpmmSorted",
                     "_GatherSenders"):
            stack.enter_context(mock.patch.object(tile_gat, name,
                                                  proxy(name)))
        yield used


def phase_gat_optins(device, g, ops15) -> dict:
    """Through the library surface, every counter at 0 just before each
    counted run: on each of GAT's opt-in operators (``GAT_OPTIN_OPS``),
    under each of its modes, one GAT ``gc_train_step`` at hidden 512 (bit
    dropout 0.5, seed-0 weights) and one eval forward, launching
    ``gat_optin_want``'s counts and held against the same run with the
    plain versions (the eval forward, the loss and every gradient); at
    256, under PyTorch's deterministic algorithms, each mode of
    ``GAT_OPTIN_WORDS_MODES`` with the plan's occupancy words and live list
    against the same step without them and against itself, bit for bit;
    then each diagnostic switch setting (``GAT_SWITCHES``) on the default
    operator at 128: the default path's launches, the straggler primitive
    it selects, held against the plain versions and against the default
    step; and the ``gc_train_step`` ms of every operator and setting beside
    the edge-128 default operator's and phase 15's threshold-48 operator
    at 256 (``ops15["t48"]``), two-stage, fused and under each switch."""
    from fitgnn_tpu_torch.models.models import NodeModel

    t_phase = time.perf_counter()
    ops = gat_optin_operators(g)
    phases = {}

    def model_():
        m = NodeModel("GATConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                      dropout_rate=0.5)
        return m.reset_parameters(torch.Generator().manual_seed(0)).to(
            device)

    def run(gd):
        return eval_and_step(model_(), gd, device)

    def held(what, got, ref, against="plain"):
        compare(f"{what}: eval forward kernels vs {against}", got[0], ref[0])
        compare(f"{what}: loss kernels vs {against}", got[1].reshape(1),
                ref[1].reshape(1))
        for k in ref[2]:
            compare(f"{what}: grad {k} kernels vs {against}", got[2][k],
                    ref[2][k])

    def bits(what, a, other):
        check(torch.equal(a[0], other[0]) and torch.equal(a[1], other[1])
              and all(torch.equal(a[2][k], other[2][k]) for k in a[2]),
              f"{what}: not bit for bit")

    for name, gr in ops.items():
        edge, _, _, modes = GAT_OPTIN_OPS[name]
        gd = gr.to(device)
        for mode in modes:
            what = f"gat512 optin {name} {mode} step and eval"
            with switches(MODE_ENV[mode]):
                reset_counts()
                got = run(gd)
                launches = read_counts()
                launches = at_edge(launches) if edge == EDGE else launches
                expect(launches, gat_optin_want(name, mode), what)
                phases[what] = launches
                with plain_versions():
                    ref = run(gd)
            held(what, got, ref)
            del got, ref
        plan = gd.aux.dyn_plan
        if edge == EDGE and plan is not None and plan.words is not None \
                and not gd.aux.bsr.bf16:
            bare = gd._replace(aux=dataclasses.replace(
                gd.aux, dyn_plan=dataclasses.replace(
                    plan, words=None, t_words=None, live=None)))
            for mode in GAT_OPTIN_WORDS_MODES:
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    with switches(MODE_ENV[mode]):
                        a, b_, c = run(gd), run(bare), run(gd)
                finally:
                    torch.use_deterministic_algorithms(False)
                what = f"gat512 optin {name} {mode}"
                bits(f"{what} step and eval without the plan's words", a, b_)
                bits(f"{what} step and eval twice", a, c)
                print(f"{what}: eval forward, loss and {len(a[2])} "
                      "gradients bit for bit with and without the plan's "
                      "occupancy words and live list (deterministic "
                      "algorithms)")
                del a, b_, c
            del bare
        del gd
        torch.cuda.empty_cache()

    # the diagnostic switches on the default operator at 128
    base = att_unit_128(g)
    gd = base.to(device)
    want = {k: STEP["GATConv"].get(k, 0) + EVAL["GATConv"].get(k, 0)
            for k in (*STEP["GATConv"], *EVAL["GATConv"])}
    with straggler_branches() as used:
        default = run(gd)
    check(not used, f"the default GAT step ran {sorted(used)}")
    for sname, (env, branch) in GAT_SWITCHES.items():
        what = f"gat512 switch {sname} step and eval"
        with switches(env), straggler_branches() as used:
            reset_counts()
            got = run(gd)
            launches = read_counts()
            expect(launches, want, what)
            phases[what] = launches
            with plain_versions():
                ref = run(gd)
        check(used == branch, f"{what}: ran {sorted(used)}, expected "
              f"{sorted(branch)}")
        print(f"{what}: the straggler primitives {sorted(used)}")
        held(what, got, ref)
        held(what, got, default, "the default step")
        del got, ref
    del gd, default
    torch.cuda.empty_cache()

    # the step's time on each operator and setting beside the yardsticks
    graphs = (("edge 128 t48", base), (f"edge {EDGE} t48", ops15["t48"]),
              *ops.items())
    step_ms("GAT two-stage hidden 512, dropout 0.5", model_, device, graphs)
    with switches(FUSED):
        step_ms("GAT fused + SEGMM_DEN hidden 512, dropout 0.5", model_,
                device, graphs)
    for sname, env in (("default", {}), *((k, v[0]) for k, v
                                          in GAT_SWITCHES.items())):
        with switches(env):
            step_ms(f"GAT switch {sname}, hidden 512, dropout 0.5", model_,
                    device, graphs[:1])
    print(f"GAT opt-in and switch steps: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return phases


# ---- phase 19: the hierarchical layer in a one-rank NCCL world -------------

HIER_THRESHOLD = 150               # build_hier_plan's default threshold
HIER_TIMED = 5
# a hier step and eval at hidden 512 launch what the single-device ones do:
# the same layers' dense work around the rank's interior operator (K1 and
# K3 for GCN, SAGE and GIN); GAT's interior has no plan and launches none
HIER_STEP = {"GCNConv": {"K1": 3, "K3": 3}, "SAGEConv": {"K1": 3, "K3": 3},
             "GINConv": {"K1": 3, "K3": 3}, "GATConv": {}}
HIER_EVAL = {"GCNConv": {"K1": 2, "K3": 2}, "SAGEConv": {"K1": 2, "K3": 2},
             "GINConv": {"K1": 2, "K3": 2}, "GATConv": {}}


def tiles_apart(hyb, ref_op) -> list:
    """The (block row, block column) tiles that one operator holds and the
    other does not, each tagged with the operator that holds it."""
    def tiles(op):
        if op.bsr is None:
            return set()
        return set(zip(op.bsr.rows.tolist(), op.bsr.cols.tolist()))
    a, b = tiles(hyb), tiles(ref_op)
    return ([("interior", *t) for t in sorted(a - b)]
            + [("single-device", *t) for t in sorted(b - a)])


def phase_hier(device, tmp, ds, g, order) -> dict:
    """Phase 19 (see the module docstring): returns the launches of each
    layer's counted hier step and eval."""
    import torch.distributed as dist
    from fitgnn_tpu_torch.graph.optimize import (_LAYER_SEMANTICS,
                                                 _operator_weights)
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
    from fitgnn_tpu_torch.parallel import (HierNodeModel, build_hier_plan,
                                           hier_eval_step, hier_train_step,
                                           initialize_distributed,
                                           make_hier_mesh, shard_graph)
    from fitgnn_tpu_torch.train import steps

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    initialize_distributed(device, f"file://{tmp}/hier_store", 0, 1)
    phases = {}
    try:
        mesh = make_hier_mesh(1, 1)
        check(dist.get_backend() == "nccl", "phase 19 is not on NCCL")
        s_np = g.senders.numpy().astype(np.int64)
        r_np = g.receivers.numpy().astype(np.int64)
        n_pad = g.num_nodes_padded
        # phase 3's graph carries the train mask alone: the test rows in
        # its order
        ref_test = torch.zeros(n_pad, dtype=torch.bool)
        ref_test[:NUM_NODES] = torch.from_numpy(ds.test_mask[order])
        ref_test = ref_test.to(device)
        for layer in ("GCNConv", "SAGEConv", "GINConv", "GATConv"):
            sem = _LAYER_SEMANTICS[layer]
            t0 = time.perf_counter()
            sg = shard_graph(ds.x, ds.senders, ds.receivers, ds.y, 1,
                             train_mask=ds.train_mask, val_mask=ds.val_mask,
                             test_mask=ds.test_mask, order=order,
                             semantics=sem)
            n_loc = sg.nodes_per_shard
            plan = build_hier_plan(sg.senders, sg.receivers, sg.edge_weight,
                                   1, 1, n_loc, np.arange(n_loc) // 128,
                                   interior_semantics=sem)
            rp = plan.local(mesh, device)
            ref_op = build_hybrid(
                s_np, r_np, _operator_weights(s_np, r_np,
                                              g.edge_weight.numpy(), n_pad,
                                              sem), n_pad,
                min_block_edges=HIER_THRESHOLD, use_segmm=True,
                semantics=sem, real_nodes=NUM_NODES)
            gd = g._replace(aux=ref_op).to(device)
            hyb = rp.int_hybrid
            print(f"hier {layer}: plan and operators in "
                  f"{time.perf_counter() - t0:.1f} s host; interior "
                  f"{0 if hyb.bsr is None else hyb.bsr.nnz_blocks} tiles, "
                  f"{hyb.num_coo_edges} stragglers (single-device "
                  f"operator at {HIER_THRESHOLD}: "
                  f"{0 if ref_op.bsr is None else ref_op.bsr.nnz_blocks} "
                  f"tiles, {ref_op.num_coo_edges} stragglers); halo and "
                  f"summary edges {int((plan.halo_weights != 0).sum())} / "
                  f"{int((plan.sum_weights != 0).sum())}")
            check(n_loc == NUM_NODES and hyb.dyn_plan is None,
                  f"hier {layer}: unexpected shard or interior")
            print(f"hier {layer}: tiles apart from the interior's "
                  f"{tiles_apart(hyb, ref_op)} (single-device operator's "
                  f"rows over n_pad {n_pad} of {NUM_NODES} real)")
            shard = sg.local(0, device)

            def models():
                ref = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                                dropout_rate=0.0)
                ref.reset_parameters(torch.Generator().manual_seed(0))
                hier = HierNodeModel(layer, NUM_FEATURES, HIDDEN, 2,
                                     NUM_CLASSES, dropout_rate=0.0)
                hier.load_state_dict(ref.state_dict())
                return ref.to(device), hier.to(device)

            ref, hier = models()
            ref.eval()
            hier.eval()
            # the single-device reference runs on the plain versions, so
            # the hier path's K1 and K3 are held against bsr_spmm_acc_plain
            # and segmm_spmm_plain on its own operator, forward and back
            reset_counts()
            with torch.no_grad(), plain_versions():
                r_out = ref(gd.x, gd)[:NUM_NODES]
                r_loss, r_metric = steps.gc_eval_step(
                    ref, gd, gd.y, ref_test, "classification")
            torch.cuda.synchronize()
            expect(read_counts(), {}, f"hier {layer} plain eval reference")
            with torch.no_grad():
                compare(f"hier {layer} eval forward", hier(shard.x, rp),
                        r_out)
            reset_counts()
            loss, metric = hier_eval_step(hier, shard.x, shard.y,
                                          shard.test_mask, rp,
                                          "classification")
            torch.cuda.synchronize()
            launches = read_counts()
            expect(launches, HIER_EVAL[layer], f"hier {layer} eval")
            phases[f"hier {layer} eval"] = launches
            compare(f"hier {layer} eval (loss, metric)",
                    torch.stack([loss, metric]).float(),
                    torch.stack([r_loss, r_metric]).float())
            opt_h = steps.adam_l2(hier.parameters(), 0.01, 5e-4)
            opt_r = steps.adam_l2(ref.parameters(), 0.01, 5e-4)
            relus = ReluMasks()     # GIN's kinks, as phase 10's
            reset_counts()
            with relus.record():
                loss = hier_train_step(hier, opt_h, shard.x, shard.y,
                                       shard.train_mask, rp, None,
                                       "classification")
            torch.cuda.synchronize()
            launches = read_counts()
            expect(launches, HIER_STEP[layer], f"hier {layer} train step")
            phases[f"hier {layer} step"] = launches
            reset_counts()
            with plain_versions(), relus.replay():
                r_loss = steps.gc_train_step(ref, opt_r, gd, gd.y,
                                             gd.train_mask, None,
                                             "classification")
            torch.cuda.synchronize()
            expect(read_counts(), {}, f"hier {layer} plain step reference")
            relus.report(f"hier {layer} step, plain reference")
            compare(f"hier {layer} step loss", loss.reshape(1),
                    r_loss.reshape(1))
            r_grads = dict(ref.named_parameters())
            for k, p in hier.named_parameters():
                compare(f"hier {layer} grad {k}", p.grad, r_grads[k].grad)

            times = {
                "hier step": cuda_ms(lambda: hier_train_step(
                    hier, opt_h, shard.x, shard.y, shard.train_mask, rp,
                    None, "classification"), HIER_TIMED),
                "single-device step": cuda_ms(lambda: steps.gc_train_step(
                    ref, opt_r, gd, gd.y, gd.train_mask, None,
                    "classification"), HIER_TIMED),
                "hier eval": cuda_ms(lambda: hier_eval_step(
                    hier, shard.x, shard.y, shard.test_mask, rp,
                    "classification"), HIER_TIMED),
                "single-device eval": cuda_ms(lambda: steps.gc_eval_step(
                    ref, gd, gd.y, ref_test, "classification"),
                    HIER_TIMED)}
            print(f"hier {layer} ms (CUDA events over {HIER_TIMED}, "
                  f"hidden {HIDDEN}, {smi}): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
            del hier, ref, opt_h, opt_r, gd, rp, plan, sg, shard, ref_op
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return phases


# phase 20: the distributed curriculum at one NCCL rank on phase 8's
# partition (its Gc and subgraph batch, from the port's cache)
DIST_GC_NODES = 84_586
DIST_SUBGRAPHS = 84_759
DIST_N_PAD = 24
DIST_EPOCHS = 2


def _cached_partition(tmp):
    """Phase 8's partition, through the CLI's ``_partition`` on phase 8's
    flags; fails if it is not in the cache."""
    from fitgnn_tpu_torch.cli import main as cli
    from fitgnn_tpu_torch.partition import pipeline

    args = cli.arg_correction(cli.build_parser().parse_args([
        "train", "--dataset", "bench", "--data_root",
        os.path.join(tmp, "dataset"), "--experiment", "random"]))
    ds = cli._load_node(args)
    train, val, test = cli._splits(args, ds, ds.num_classes)

    def missed(*a, **k):
        raise Failed("phase 20: phase 8's partition is not in the cache")

    t0 = time.perf_counter()
    with mock.patch.object(pipeline, "coarsen_and_partition", missed):
        part = cli._partition(args, ds, train, val, test, ds.num_classes)
    print(f"dist curriculum: phase 8's partition from the cache in "
          f"{time.perf_counter() - t0:.1f} s")
    return part


def _seeded_pair(layer, device):
    """Two NodeModels with the same seed-0 parameters, dropout off."""
    from fitgnn_tpu_torch.models.models import NodeModel
    ref = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                    dropout_rate=0.0)
    ref.reset_parameters(torch.Generator().manual_seed(0))
    model = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                      dropout_rate=0.0)
    model.load_state_dict(ref.state_dict())
    return ref.to(device), model.to(device)


def _bitwise(got: dict, ref: dict) -> bool:
    return all(torch.equal(got[k], ref[k]) for k in ref)


def phase_dist_curriculum(device, tmp, single) -> dict:
    """Phase 20 (see the module docstring): returns the launches of the
    hier Gc step and eval and of the 2 + 2-epoch run."""
    import torch.distributed as dist
    from fitgnn_tpu_torch.graph.optimize import optimize_coarse
    from fitgnn_tpu_torch.parallel import hier_view, initialize_distributed
    from fitgnn_tpu_torch.train import loop, steps

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    part = _cached_partition(tmp)
    batch = part.subgraphs
    check(int(part.coarse.graph.n_node) == DIST_GC_NODES
          and batch.num_subgraphs == DIST_SUBGRAPHS
          and batch.num_nodes_padded == DIST_N_PAD,
          "phase 20: not phase 8's partition")
    # at one rank the placement keeps the Gc's order, and in the
    # partition's order no 128 x 128 block of the Gc holds HIER_THRESHOLD
    # edges; the Gc in optimize_coarse's Leiden order (the single-device
    # Gc phase's), whose operator at HIER_THRESHOLD is the reference
    g0 = part.coarse.graph
    e = int(g0.n_edge)
    blocks = np.unique(g0.receivers[:e].numpy().astype(np.int64) // 128
                       * (g0.num_nodes_padded // 128 + 1)
                       + g0.senders[:e].numpy() // 128, return_counts=True)[1]
    t0 = time.perf_counter()
    coarse = optimize_coarse(part.coarse, seed=0, layer_name="GCNConv",
                             min_block_edges=HIER_THRESHOLD)
    ref_op = coarse.graph.aux
    print(f"dist curriculum: Gc {DIST_GC_NODES} nodes, blocks of >= "
          f"{HIER_THRESHOLD} edges in the partition's order "
          f"{int((blocks >= HIER_THRESHOLD).sum())}; Leiden order in "
          f"{time.perf_counter() - t0:.1f} s host, single-device operator "
          f"at {HIER_THRESHOLD}: {ref_op.bsr.nnz_blocks} tiles, "
          f"{ref_op.num_coo_edges} stragglers")
    cd = coarse.to(device)
    initialize_distributed(device, f"file://{tmp}/dist_store", 0, 1)
    phases = {}
    base = dict(hidden=HIDDEN, num_layers=2, out_dim=NUM_CLASSES,
                task="classification", device=str(device), num_devices=1,
                num_hosts=1, distributed=True, seed=0)
    try:
        check(dist.get_backend() == "nccl", "phase 20 is not on NCCL")
        # 1. the hierarchical Gc phase, GCN: a step and an eval
        t0 = time.perf_counter()
        hs = loop._make_hier_gc_steps(
            loop.NodeTaskConfig(layer_name="GCNConv", **base), coarse,
            device)
        hyb, plan = hs.rank_plan.int_hybrid, hs.host.plan
        print(f"dist curriculum hier Gc GCN: plan and interior in "
              f"{time.perf_counter() - t0:.1f} s host; shard "
              f"{hs.host.sg.nodes_per_shard} rows; interior "
              f"{0 if hyb.bsr is None else hyb.bsr.nnz_blocks} tiles, "
              f"{hyb.num_coo_edges} stragglers; halo and summary edges "
              f"{int((plan.halo_weights != 0).sum())} / "
              f"{int((plan.sum_weights != 0).sum())}; tiles apart "
              f"{tiles_apart(hyb, ref_op)}")
        check(hyb.bsr is not None and hyb.bsr.nnz_blocks > 0
              and hyb.num_coo_edges > 0, "phase 20: no hybrid interior")
        ref, model = _seeded_pair("GCNConv", device)
        hmodel = hier_view(model)
        gd = cd.graph
        reset_counts()
        with plain_versions():
            r_loss, r_metric = steps.gc_eval_step(ref, gd, cd.y_val,
                                                  cd.val_mask,
                                                  "classification")
        torch.cuda.synchronize()
        expect(read_counts(), {}, "dist curriculum plain Gc eval reference")
        reset_counts()
        loss, metric = hs.evaluate(hmodel)
        torch.cuda.synchronize()
        launches = read_counts()
        expect(launches, HIER_EVAL["GCNConv"], "dist curriculum hier Gc eval")
        phases["dist curriculum hier Gc eval"] = launches
        compare("dist curriculum hier Gc eval (loss, metric)",
                torch.stack([loss, metric]).float(),
                torch.stack([r_loss, r_metric]).float())
        opt_h = steps.adam_l2(model.parameters(), 0.01, 5e-4)
        opt_r = steps.adam_l2(ref.parameters(), 0.01, 5e-4)
        reset_counts()
        loss = hs.train(hmodel, opt_h, None)
        torch.cuda.synchronize()
        launches = read_counts()
        expect(launches, HIER_STEP["GCNConv"], "dist curriculum hier Gc step")
        phases["dist curriculum hier Gc step"] = launches
        reset_counts()
        with plain_versions():
            r_loss = steps.gc_train_step(ref, opt_r, gd, cd.y_train,
                                         cd.train_mask, None,
                                         "classification")
        torch.cuda.synchronize()
        expect(read_counts(), {}, "dist curriculum plain Gc step reference")
        compare("dist curriculum hier Gc step loss", loss.reshape(1),
                r_loss.reshape(1))
        r_grads = dict(ref.named_parameters())
        for k, p in model.named_parameters():
            compare(f"dist curriculum hier Gc grad {k}", p.grad,
                    r_grads[k].grad)
        times = {
            "hier step": cuda_ms(lambda: hs.train(hmodel, opt_h, None),
                                 HIER_TIMED),
            "single-device step": cuda_ms(lambda: steps.gc_train_step(
                ref, opt_r, gd, cd.y_train, cd.train_mask, None,
                "classification"), HIER_TIMED),
            "hier eval": cuda_ms(lambda: hs.evaluate(hmodel), HIER_TIMED),
            "single-device eval": cuda_ms(lambda: steps.gc_eval_step(
                ref, gd, cd.y_val, cd.val_mask, "classification"),
                HIER_TIMED)}
        print(f"dist curriculum hier Gc GCN ms (CUDA events over "
              f"{HIER_TIMED}, hidden {HIDDEN}, dropout off, {smi}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
        del hs, hmodel, ref, model, opt_h, opt_r
        # GAT's eval forward: the interior's einsum branch, no launch
        hs = loop._make_hier_gc_steps(
            loop.NodeTaskConfig(layer_name="GATConv", **base), coarse,
            device)
        ref, model = _seeded_pair("GATConv", device)
        reset_counts()
        with plain_versions():
            r_loss, r_metric = steps.gc_eval_step(
                ref, gd._replace(aux=None), cd.y_val, cd.val_mask,
                "classification")
        torch.cuda.synchronize()
        expect(read_counts(), {}, "dist curriculum plain GAT eval")
        reset_counts()
        loss, metric = hs.evaluate(hier_view(model))
        torch.cuda.synchronize()
        launches = read_counts()
        expect(launches, HIER_EVAL["GATConv"],
               "dist curriculum hier Gc GAT eval")
        compare("dist curriculum hier Gc GAT eval (loss, metric)",
                torch.stack([loss, metric]).float(),
                torch.stack([r_loss, r_metric]).float())
        del hs, ref, model, cd, gd
        torch.cuda.empty_cache()

        # 2. the subgraph-sharded Gs steps against the single-device ones,
        # one side at a time (a GD step peaks near 30 GiB)
        for method in ("GD", "MB"):
            cfg = loop.NodeTaskConfig(layer_name="GCNConv",
                                      gradient_method=method, **base)
            ref, model = _seeded_pair("GCNConv", device)
            train, evaluate = loop._make_dist_steps(cfg, (batch,), device)
            opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
            side = {}
            for name, fn in (
                    ("dist", lambda: (train(model, opt, None),
                                      evaluate(model, "val"), model)),
                    ("single", lambda: (loop._gs_train_epoch(
                        ref, opt_r, bd, None, cfg),
                        loop._gs_eval(ref, bd, cfg, "val"), ref))):
                if name == "single":
                    del train, evaluate, opt
                    torch.cuda.empty_cache()
                    bd = (batch.to(device),)
                    opt_r = steps.adam_l2(ref.parameters(), 0.01, 5e-4)
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.perf_counter()
                loss, (v_loss, v_metric), m = fn()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                expect(read_counts(), {}, f"dist curriculum Gs {method} "
                       f"({name})")
                side[name] = dict(
                    loss=torch.as_tensor(float(loss)).reshape(1),
                    val=torch.tensor([v_loss, v_metric]),
                    grads={k: p.grad.detach().clone()
                           for k, p in m.named_parameters()},
                    params={k: v.detach().clone()
                            for k, v in m.state_dict().items()})
                print(f"dist curriculum Gs {method} epoch + val eval "
                      f"({name}): {secs:.3f} s, peak "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del bd, opt_r, ref, model
            torch.cuda.empty_cache()
            got, want = side["dist"], side["single"]
            compare(f"dist curriculum Gs {method} loss", got["loss"],
                    want["loss"])
            compare(f"dist curriculum Gs val eval (loss, metric) after "
                    f"{method}", got["val"], want["val"])
            what = "last step's grad" if method == "MB" else "grad"
            for k, v in want["grads"].items():
                compare(f"dist curriculum Gs {method} {what} {k}",
                        got["grads"][k], v)
            for k, v in want["params"].items():
                compare(f"dist curriculum Gs {method} param {k}",
                        got["params"][k], v)
            print(f"dist curriculum Gs {method}: bit for bit the single-"
                  f"device side: loss "
                  f"{torch.equal(got['loss'], want['loss'])}, val eval "
                  f"{torch.equal(got['val'], want['val'])}, grads "
                  f"{_bitwise(got['grads'], want['grads'])}, params "
                  f"{_bitwise(got['params'], want['params'])}")

        # 3. Gc_train_2_Gs_train through run_node_task's distributed path
        cfg = loop.NodeTaskConfig(layer_name="GCNConv",
                                  exp_setup="Gc_train_2_Gs_train",
                                  epochs1=DIST_EPOCHS, epochs2=DIST_EPOCHS,
                                  runs=1, **base)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        res = loop.run_node_task(cfg, coarse, batch, verbose=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        expect(launches, {k: DIST_EPOCHS * (HIER_STEP["GCNConv"][k]
                                            + HIER_EVAL["GCNConv"][k])
                          for k in HIER_STEP["GCNConv"]},
               "dist curriculum run")
        phases["dist curriculum run"] = launches
        r = res.runs[0]
        check(np.isfinite(r.test_loss) and r.test_loss > 0
              and len(r.gc_epoch_seconds) == DIST_EPOCHS
              and len(r.gs_epoch_seconds) == DIST_EPOCHS,
              f"dist curriculum run: {r}")
        gc_ms, gs_s, test_s = single["cur_gcn"][0], single["cur_gcn_gd"][1], \
            single["cur_gcn_gd"][2]
        print(f"dist curriculum Gc_train_2_Gs_train {DIST_EPOCHS} + "
              f"{DIST_EPOCHS} epochs at one NCCL rank, hidden {HIDDEN}, "
              f"dropout 0.5 ({smi}): {wall:.1f} s; hier Gc epoch ms "
              f"{[round(t * 1e3, 3) for t in r.gc_epoch_seconds]}; Gs "
              f"epoch s {[round(t, 4) for t in r.gs_epoch_seconds]}; test "
              f"eval {r.test_time:.4f} s; test loss {r.test_loss:.4f} "
              f"metric {r.test_acc:.4f}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | phase "
              f"8 single-device: Gc epoch ms {gc_ms} (cur_gcn, threshold "
              f"48), Gs epoch s {gs_s}, test eval {test_s:.4f} s "
              "(cur_gcn_gd)")
    finally:
        dist.destroy_process_group()
    return phases


# phase 21: the flat data mesh at one NCCL rank on the bench graph
FLAT_TIMED = 5
FLAT_LAYERS = ("GCNConv", "SAGEConv", "GINConv", "GATConv")


def phase_flat(device, tmp, ds, g) -> dict:
    """Phase 21 (see the module docstring): returns the (empty) launches
    of each layer's counted steps and evals."""
    import torch.distributed as dist
    from fitgnn_tpu_torch.graph.build import build_graph
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.parallel import (LAYER_SEMANTICS, DistNodeModel,
                                           DistNodeModelHalo,
                                           build_halo_plan, dist_eval_step,
                                           initialize_distributed,
                                           make_dist_eval_step,
                                           make_dist_train_step,
                                           make_halo_train_step, make_mesh,
                                           placement_by_community,
                                           shard_graph)
    from fitgnn_tpu_torch.partition.community import leiden_communities
    from fitgnn_tpu_torch.train import steps

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    task = "classification"
    n = ds.num_nodes
    t0 = time.perf_counter()
    labels = leiden_communities(ds.senders, ds.receivers, n, seed=0)
    place, _ = placement_by_community(labels, 1)
    check(np.array_equal(place, np.arange(n)),
          "phase 21: the placement at one shard is not the identity")

    def shard(sem):
        return shard_graph(ds.x, ds.senders, ds.receivers, ds.y, 1,
                           train_mask=ds.train_mask, val_mask=ds.val_mask,
                           test_mask=ds.test_mask, order=place,
                           semantics=sem)

    # the single-device reference: the GCN shard's real edges as a
    # per-edge graph in the shard's node order (GCN reads its weights,
    # SAGE and GIN its non-self edges, GAT its edge mask)
    sg = shard("gcn_norm")
    real = sg.edge_weight[0] != 0
    gref = build_graph(sg.x[0], sg.senders[0][real], sg.receivers[0][real],
                       edge_weight=sg.edge_weight[0][real], y=sg.y[0],
                       train_mask=sg.train_mask[0],
                       test_mask=sg.test_mask[0], undirected=False,
                       self_loops=False, normalize=False)
    print(f"flat: Leiden ({int(labels.max()) + 1} communities), the "
          f"placement (the identity at one shard) and the reference graph "
          f"in {time.perf_counter() - t0:.1f} s host")
    initialize_distributed(device, f"file://{tmp}/flat_store", 0, 1)
    phases = {}
    try:
        mesh = make_mesh(1)
        check(dist.get_backend() == "nccl", "phase 21 is not on NCCL")
        gd, g3 = gref.to(device), g.to(device)
        del gref
        for layer in FLAT_LAYERS:
            t0 = time.perf_counter()
            if layer != "GCNConv":
                sg = shard(LAYER_SEMANTICS[layer])
            plan = build_halo_plan(sg.senders, sg.receivers, sg.edge_weight,
                                   1, sg.nodes_per_shard)
            e_real = int((sg.edge_weight[0] != 0).sum())
            print(f"flat {layer}: shard and plan in "
                  f"{time.perf_counter() - t0:.1f} s host; E_loc "
                  f"{sg.senders.shape[1]} ({e_real} real edges), n_loc "
                  f"{sg.nodes_per_shard}, halo K {plan.k}, "
                  f"{int(plan.send_mask.sum())} boundary rows")
            check(sg.nodes_per_shard == n and plan.k == 8
                  and not plan.send_mask.any(),
                  f"flat {layer}: unexpected shard or plan at one rank")
            local = sg.local(0, device)
            edges, lp = sg.local_edges(0, device), plan.local(0, device)
            ref = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                            dropout_rate=0.0)
            ref.reset_parameters(torch.Generator().manual_seed(0))
            ag = DistNodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                               dropout_rate=0.0)
            halo = DistNodeModelHalo(layer, NUM_FEATURES, HIDDEN, 2,
                                     NUM_CLASSES, dropout_rate=0.0)
            for m in (ag, halo):
                m.load_state_dict(ref.state_dict())
                m.to(device)
            ref.to(device)
            opts = [steps.adam_l2(m.parameters(), 0.01, 5e-4)
                    for m in (ag, halo, ref)]
            step_a = make_dist_train_step(mesh, ag)
            step_h = make_halo_train_step(mesh, halo, lp)
            relus = ReluMasks()        # GIN's kinks, as phase 10's
            # the two tables under deterministic algorithms (the segment
            # sums' index_add_ adds atomically otherwise), bit for bit
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                reset_counts()
                ag.eval()
                with torch.no_grad():
                    out = ag(local.x, edges.senders, edges.receivers,
                             edges.edge_weight, group=mesh.chip_group)
                ev_a = make_dist_eval_step(mesh, ag, "test")(local, edges)
                ev_h = dist_eval_step(halo, local, lp, "test",
                                      mesh.chip_group)
                with relus.record():
                    loss_a = step_a(opts[0], local, edges)
                loss_h = step_h(opts[1], local)
                torch.cuda.synchronize()
                launches = read_counts()
            finally:
                torch.use_deterministic_algorithms(False)
            expect(launches, {}, f"flat {layer} eval and steps")
            phases[f"flat {layer} steps"] = launches
            same = (torch.equal(torch.stack(ev_a), torch.stack(ev_h))
                    and torch.equal(loss_a, loss_h)
                    and all(torch.equal(pa.grad, ph.grad)
                            and torch.equal(pa, ph)
                            for pa, ph in zip(ag.parameters(),
                                              halo.parameters())))
            check(same, f"flat {layer}: the halo table's eval and step are "
                  "not bit for bit the all-gather table's")
            print(f"flat {layer}: the halo table's eval, step loss, "
                  "gradients and parameters bit for bit the all-gather "
                  "table's (deterministic algorithms)")
            ref.eval()
            with torch.no_grad():
                r_out = ref(gd.x, gd)[:n]
                r_ev = steps.gc_eval_step(ref, gd, gd.y, gd.test_mask, task)
            compare(f"flat {layer} eval forward", out, r_out)
            compare(f"flat {layer} eval (loss, metric)",
                    torch.stack(ev_a).float(), torch.stack(r_ev).float())
            with relus.replay():
                r_loss = steps.gc_train_step(ref, opts[2], gd, gd.y,
                                             gd.train_mask, None, task)
            relus.report(f"flat {layer} step, single-device reference")
            compare(f"flat {layer} step loss", loss_a.reshape(1),
                    r_loss.reshape(1))
            r_grads = dict(ref.named_parameters())
            for k, p in ag.named_parameters():
                compare(f"flat {layer} grad {k}", p.grad, r_grads[k].grad)

            times = {
                "all-gather step": cuda_ms(
                    lambda: step_a(opts[0], local, edges), FLAT_TIMED),
                "halo step": cuda_ms(lambda: step_h(opts[1], local),
                                     FLAT_TIMED),
                "single-device step (per edge)": cuda_ms(
                    lambda: steps.gc_train_step(ref, opts[2], gd, gd.y,
                                                gd.train_mask, None, task),
                    FLAT_TIMED)}
            if layer == "GCNConv":
                # the single-device path of train --baseline: phase 3's
                # hybrid operator (K3, then K1)
                times["single-device step (phase 3's operator)"] = cuda_ms(
                    lambda: steps.gc_train_step(ref, opts[2], g3, g3.y,
                                                g3.train_mask, None, task),
                    FLAT_TIMED)
            print(f"flat {layer} ms (CUDA events over {FLAT_TIMED}, hidden "
                  f"{HIDDEN}, dropout off, {e_real} edges, {smi}): "
                  + ", ".join(f"{k} {v:.3f} ({e_real / v / 1e3:.1f} M "
                              "edges/s)" for k, v in times.items()))
            del ref, ag, halo, opts, local, edges, lp, plan
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    del gd, g3
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "scripts", "torch_scaling_bench.py"), "--devices",
         "1"], capture_output=True, text=True, timeout=600)
    check(bench.returncode == 0, "scripts/torch_scaling_bench.py --devices 1 "
          f"failed:\n{bench.stderr[-3000:]}")
    line = [ln for ln in bench.stdout.splitlines() if ln.startswith("P=1:")]
    check(len(line) == 1, f"scaling bench: no P=1 line in {bench.stdout!r}")
    print(f"flat scaling bench (--devices 1, the script's graph, "
          f"{time.perf_counter() - t0:.1f} s): {line[0]}")
    return phases


# phase 22: a Cora-shaped Planetoid raw set
CORA_NODES, CORA_FEATURES, CORA_CLASSES = 2708, 1433, 7
CORA_TRAIN, CORA_TEST = 140, 1000


def write_planetoid_cora(root: str, seed: int = 0) -> None:
    """``<root>/cora/raw/ind.cora.*`` from ``seed``: 2,708 nodes, 1,433
    binary features around a class centre each, 7 classes, neighbours
    drawn mostly among a node's class; 140 rows of ``x``/``y``, 1,000
    test ids in a shuffled index file, ``tx``/``ty`` in its order, as
    Planetoid's files hold them."""
    import pickle

    import scipy.sparse as sp

    raw = os.path.join(root, "cora", "raw")
    os.makedirs(raw)
    rng = np.random.default_rng(seed)
    n, f, c = CORA_NODES, CORA_FEATURES, CORA_CLASSES
    n_allx = n - CORA_TEST
    y = rng.integers(0, c, n)
    centres = rng.random((c, f)) < 0.02
    x = (centres[y] | (rng.random((n, f)) < 0.01)).astype(np.float32)
    by_class = np.argsort(y, kind="stable")
    pos = np.empty(n, dtype=np.int64)
    pos[by_class] = np.arange(n)
    graph = {}
    for i in range(n):
        near = by_class[np.clip(pos[i] + rng.integers(-20, 21, 3), 0, n - 1)]
        graph[i] = sorted({int(v) for v in near} | {int(rng.integers(n))})
    test_idx = rng.permutation(np.arange(n_allx, n))
    onehot = np.eye(c)[y]
    objs = dict(x=sp.csr_matrix(x[:CORA_TRAIN]), y=onehot[:CORA_TRAIN],
                tx=sp.csr_matrix(x[test_idx]), ty=onehot[test_idx],
                allx=sp.csr_matrix(x[:n_allx]), ally=onehot[:n_allx],
                graph=graph)
    for key, obj in objs.items():
        with open(os.path.join(raw, f"ind.cora.{key}"), "wb") as fo:
            pickle.dump(obj, fo)
    with open(os.path.join(raw, "ind.cora.test.index"), "w") as fo:
        fo.write("\n".join(str(i) for i in test_idx))


def phase_planetoid(tmp) -> dict:
    """Phase 22 (see the module docstring): returns the launches of the
    ``train --baseline`` run."""
    from fitgnn_tpu_torch.data.datasets import load_node_dataset
    from fitgnn_tpu_torch.data.stats import DatasetStats
    from fitgnn_tpu_torch.utils.results import TRAIN_NODE_CLS_HEADER

    t0 = time.perf_counter()
    root = os.path.join(tmp, "dataset")
    write_planetoid_cora(root)
    ds = load_node_dataset("cora", root)
    check(ds.x.shape == (CORA_NODES, CORA_FEATURES)
          and ds.num_classes == CORA_CLASSES
          and int(ds.train_mask.sum()) == CORA_TRAIN
          and int(ds.test_mask.sum()) == CORA_TEST,
          f"planetoid: unexpected arrays {ds.x.shape}, {ds.num_classes} "
          "classes")
    print(f"planetoid: raw files written and read in "
          f"{time.perf_counter() - t0:.1f} s host ({len(ds.senders)} "
          "edges)")
    launches, _, wall = run_cli(tmp, ["stats"], dataset="cora")
    expect(launches, {}, "planetoid stats")
    row = read_rows(os.path.join(tmp, "dataset_info.csv"),
                    DatasetStats.CSV_HEADER)[-1]
    check(row["dataset"] == "cora" and row["num_nodes"] == str(CORA_NODES)
          and row["num_features"] == str(CORA_FEATURES)
          and row["num_classes"] == str(CORA_CLASSES), f"stats row {row}")
    print(f"planetoid stats: {wall:.1f} s; dataset_info.csv row {row}")
    launches, _, wall = run_cli(tmp, [
        "train", "--baseline", "--hidden", str(HIDDEN), "--runs", "1",
        "--epochs1", "5", "--output_dir", "cora"], dataset="cora")
    expect(launches, {}, "planetoid train --baseline")
    rows = read_rows(os.path.join(tmp, "results", "baseline", "cora.csv"),
                     TRAIN_NODE_CLS_HEADER)
    check(len(rows) == 1 and np.isfinite(float(rows[0]["best_loss"]))
          and float(rows[0]["best_loss"]) > 0, f"train row {rows}")
    check(not os.path.exists(os.path.join(root, "cora", "cora.npz")),
          "planetoid: an npz cache appeared")
    print(f"planetoid train --baseline: {wall:.1f} s; best_acc "
          f"{rows[0]['best_acc']} best_loss {rows[0]['best_loss']} "
          f"ave_time {rows[0]['ave_time']}")
    return {"planetoid train": launches}


# ---- phase 23: tiles of f16, fp8 e4m3fn and fp8 e5m2 -----------------------

# the JAX package's other tile types (build_hybrid(tile_dtype=...)): the
# card holds such tiles widened to f32 and runs the f32 forms on them
LOWP = {"f16": torch.float16, "e4m3": torch.float8_e4m3fn,
        "e5m2": torch.float8_e5m2}
# phase 23's counted runs: name -> (build_hybrid flags, semantics, mode)
LP_RUNS = {"gcn diag": (dict(use_diag=True), "gcn_norm", "GCNConv"),
           "gat": ({}, "att_unit", "GATConv fused")}


def widened(h):
    """The operator with its tiles and diagonal blocks widened to f32 on
    the host: what the card's copy of an f16 or fp8 operator must equal."""
    def wide(b, **kw):
        return dataclasses.replace(b, blocks=b.blocks.float(), **kw)

    return dataclasses.replace(
        h, bsr=wide(h.bsr, transpose=wide(h.bsr.transpose)),
        diag_blocks=None if h.diag_blocks is None
        else h.diag_blocks.float())


def phase_tile_types(device, g) -> dict:
    """Phase 23: tiles of f16, fp8 e4m3fn and fp8 e5m2 (see the list at
    the top).  Returns the counted runs' launches."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.ops.bsr_spmm import cast_tiles
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

    t_phase = time.perf_counter()
    s = g.senders.numpy().astype(np.int64)
    r = g.receivers.numpy().astype(np.int64)
    w, n = g.edge_weight.numpy(), g.num_nodes_padded
    pres = (w > 0).astype(np.float32)

    def build(kw, sem, dtype=None):
        return build_hybrid(s, r, pres if sem == "att_unit" else w, n,
                            min_block_edges=48, use_segmm=True,
                            semantics=sem, tile_dtype=dtype, **kw)

    def model_(layer):
        if layer == "GCNConv":
            m = NodeModel("GCNConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                          dropout_rate=0.5, fused_dropout=True,
                          bit_dropout=False)
        else:
            m = NodeModel("GATConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                          dropout_rate=0.5)
        return m.reset_parameters(torch.Generator().manual_seed(0)).to(
            device)

    def bitwise(a, b):
        return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                and all(torch.equal(a[2][k], b[2][k]) for k in a[2]))

    phases, ops = {}, {}
    for run, (kw, sem, mode) in LP_RUNS.items():
        f32 = build(kw, sem)
        ops[run] = {"f32": f32}
        for t, dtype in LOWP.items():
            t0 = time.perf_counter()
            h = ops[run][t] = build(kw, sem, dtype)
            t_build = time.perf_counter() - t0
            for a, b in ((h.bsr.blocks, f32.bsr.blocks),
                         (h.bsr.transpose.blocks, f32.bsr.transpose.blocks),
                         (h.diag_blocks, f32.diag_blocks)):
                check((a is None) == (b is None) and (b is None or torch.equal(
                    a.view(torch.uint8), cast_tiles(b, dtype).view(
                        torch.uint8))),
                      f"{t} {run}: build_hybrid's tiles are not the f32 "
                      "tiles cast")
            what = f"tile type {t} {run} step and eval"
            # under deterministic algorithms (PyTorch's segment sums add
            # in a fixed order), so that the two runs may be compared bit
            # for bit
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with switches(MODE_ENV[mode]):
                    gw = g._replace(aux=widened(h)).to(device)
                    reset_counts()
                    ref = eval_and_step(model_(mode.split()[0]), gw, device)
                    want = read_counts()
                    del gw
                    gd = g._replace(aux=h).to(device)
                    check(all(a is None or a.dtype == torch.float32
                              for a in (gd.aux.bsr.blocks,
                                        gd.aux.bsr.transpose.blocks,
                                        gd.aux.diag_blocks)),
                          f"{what}: the tiles are not f32 on the card")
                    check(torch.equal(gd.aux.bsr.blocks.cpu(),
                                      h.bsr.blocks.float()),
                          f"{what}: the card's tiles are not the cast "
                          "tiles widened")
                    reset_counts()
                    got = eval_and_step(model_(mode.split()[0]), gd, device)
                    launches = read_counts()
            finally:
                torch.use_deterministic_algorithms(False)
            expect(launches, want, what)
            check(not any(v for k, v in launches.items() if k.endswith("bf")),
                  f"{what}: a bf16 form ran")
            check(bitwise(got, ref), f"{what}: differs from the same run on "
                  "the tiles widened on the host")
            print(f"{what}: build_hybrid {t_build:.1f} s host, bit for bit "
                  "the run on the host-widened tiles")
            phases[what] = launches
            del gd, got, ref
            torch.cuda.empty_cache()

    # the steps' time on f16 and e4m3 tiles beside f32, in one call each
    for run, (_, _, mode) in LP_RUNS.items():
        with switches(MODE_ENV[mode]):
            step_ms(f"{mode} hidden 512, dropout 0.5, {run}, tile types",
                    lambda: model_(mode.split()[0]), device,
                    [(t, g._replace(aux=ops[run][t]))
                     for t in ("f32", "f16", "e4m3")])
    del ops
    torch.cuda.empty_cache()
    print(f"phase 23: {time.perf_counter() - t_phase:.1f} s")
    return phases


# ---- phase 24: ingest at products scale ------------------------------------

PRODUCTS_NODES = 2_449_029        # ogbn-products' node count
INGEST_SLICE = 2_100_000          # directed edges of the two-branch check


def phase_products_ingest() -> None:
    """``planted_products_graph(2,449,029)`` (degree 25, ~30.6 M directed
    edges) through the port's ``build_graph``: the C++ branch's host
    seconds and edge count; then on its first 2.1 M edges the C++ core
    against the numpy branch, canonicalised by ``np.lexsort`` (the
    senders and receivers exactly, the weights within rtol 1e-5), as the
    JAX package's ``tests/test_native_build.py`` holds its two branches."""
    from fitgnn_tpu_torch.data.synthetic import planted_products_graph
    from fitgnn_tpu_torch.graph import build as build_mod
    from fitgnn_tpu_torch.graph.native_build import (NATIVE_EDGE_THRESHOLD,
                                                     build_edges_native)

    t0 = time.perf_counter()
    x, s, r, y = planted_products_graph(PRODUCTS_NODES)
    t_gen = time.perf_counter() - t0
    check(len(s) > NATIVE_EDGE_THRESHOLD, "products: below the C++ branch")
    calls = []
    orig = build_mod.build_edges_native

    def counted(*a, **k):
        calls.append(len(a[0]))
        return orig(*a, **k)

    with mock.patch.object(build_mod, "build_edges_native", counted):
        t0 = time.perf_counter()
        g = build_mod.build_graph(x, s, r, y=y)
        t_build = time.perf_counter() - t0
    check(calls == [len(s)], f"products: the C++ branch ran {calls}")
    ne = int(g.n_edge)
    sr, ss = g.receivers.numpy()[:ne], g.senders.numpy()[:ne]
    check(bool((np.diff(sr) >= 0).all()), "products: receivers unsorted")
    w = g.edge_weight.numpy()[:ne]
    check(bool(np.isfinite(w).all() and (w > 0).all()),
          "products: weights not finite and positive")
    print(f"products ingest: {PRODUCTS_NODES} nodes, {len(s)} directed "
          f"input edges -> {ne} edges (symmetrized, self loops; N_pad "
          f"{g.num_nodes_padded}, E_pad {g.senders.shape[0]}); generator "
          f"{t_gen:.1f} s, build_graph (C++ branch) {t_build:.1f} s host")
    del g, x, sr, ss, w
    # the two branches on a slice
    s2, r2 = s[:INGEST_SLICE].astype(np.int64), r[:INGEST_SLICE].astype(
        np.int64)
    t0 = time.perf_counter()
    ns, nr, nw = build_edges_native(s2, r2, PRODUCTS_NODES)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    ws = np.ones(len(s2), dtype=np.float32)
    os_, or_, ow = build_mod.to_undirected(s2.astype(np.int32),
                                           r2.astype(np.int32), ws)
    os_, or_, ow = build_mod.add_self_loops(os_, or_, ow, PRODUCTS_NODES)
    ow = build_mod.gcn_normalize(os_, or_, ow, PRODUCTS_NODES)
    os_, or_, ow = build_mod.sort_by_receiver(os_, or_, ow)
    t_np = time.perf_counter() - t0

    def canon(a, b, c):
        order = np.lexsort((a, b))
        return a[order], b[order], c[order]

    ns, nr, nw = canon(ns, nr, nw)
    os_, or_, ow = canon(os_.astype(np.int64), or_.astype(np.int64), ow)
    check(np.array_equal(ns, os_) and np.array_equal(nr, or_),
          "products slice: the branches' edges differ")
    check(bool(np.allclose(nw, ow, rtol=1e-5, atol=0)),
          "products slice: the branches' weights differ")
    print(f"products slice ({INGEST_SLICE} input edges, {len(ns)} out): "
          f"C++ {t_nat:.2f} s, numpy {t_np:.2f} s host; edges equal, "
          f"weights max rel diff "
          f"{float(np.max(np.abs(nw - ow) / ow)):.2e}")


# ---- phase 25: the tooling on the card -------------------------------------

def phase_tooling(device, g) -> None:
    """``measure_spmm_roofline()`` at its defaults on the card (the
    achieved GB/s against the H100's 3,350), and a ``device_trace`` of the
    bench operator's hybrid SpMM that must hold CUDA kernel events."""
    from fitgnn_tpu_torch.bench.roofline import measure_spmm_roofline
    from fitgnn_tpu_torch.ops.hybrid_spmm import hybrid_spmm
    from fitgnn_tpu_torch.utils.profiling import device_trace

    rep = measure_spmm_roofline(device=device)
    check(rep.peak_gbps == 3350.0, f"roofline: peak {rep.peak_gbps}")
    print(f"roofline (per-edge segment sum, 131,072 nodes, degree 8, F=512, "
          f"20 reps): {rep.seconds_per_spmm * 1e3:.4f} ms a call, "
          f"{rep.bytes_moved / 1e9:.3f} GB, {rep.achieved_gbps:.1f} GB/s = "
          f"{100 * rep.fraction_of_roofline:.1f}% of {rep.peak_gbps:.0f}")
    gd = g.to(device)
    with tempfile.TemporaryDirectory() as d:
        with torch.inference_mode(), device_trace(d) as prof:
            for _ in range(3):
                hybrid_spmm(gd.aux, gd.x)
        with open(os.path.join(d, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    names = {e["name"].split("<")[0] for e in kern}
    check(len(kern) >= 6, f"device_trace: {len(kern)} CUDA kernel events")
    dev_us = sum(getattr(e, "device_time_total", 0.0)
                 for e in prof.key_averages())
    print(f"device_trace: {len(events)} events, {len(kern)} CUDA kernel "
          f"events ({sorted(names)[:6]}...), device time {dev_us:.0f} us")
    del gd
    torch.cuda.empty_cache()


# ---- phase 27: GAT's dynamic tiles on bf16 activations -----------------

# bench.py's GAT configuration (FITGNN_BENCH_LAYER=GATConv with its
# defaults): the bf16 conv stack and bf16 tiles (GAT's 0/1 mask), tile
# threshold 32, use_segmm, bit dropout 0.5, edge 128, the two-stage tile
# path (no FITGNN_GAT_FUSED_TILES)
GAT_BENCH_THRESHOLD = 32
# one bf16 two-stage GAT step and one eval forward at hidden 512: K4a in
# both layers of each, K4ᵀa in layer 1's backward alone (layer 0's raw
# features need no gradient), K5a in both layers' backward; no K3wa (read
# off the first chip run of this phase: at widths 128 and 512 the
# stragglers take the den-column scatter, K3w's gate being F <= 64)
BF16_DYN_STEP = {"K4a": 4, "K4Ta": 1, "K5a": 2}
# the widths those launches see, by wrapper: layer 0 aggregates the raw
# features (GAT aggregates on the narrow side of an expanding layer),
# layer 1 the hidden width
BF16_DYN_WIDTHS = {"dyn_tiles": [NUM_FEATURES, NUM_FEATURES, HIDDEN, HIDDEN],
                   "dyn_tiles_t": [HIDDEN],
                   "dyn_grad_blocks": [NUM_FEATURES, HIDDEN]}


def dyn_a_kernel_rows(device, hd, gen, tag: str = "") -> dict:
    """K4a, K4ᵀa (on the transpose plan) and K5a on the bf16 tiles of
    ``hd``, a bf16 ``att_unit`` operator on the card, at the tiles' edge,
    with bf16 attention-like values (positive on the mask, zero elsewhere)
    and bf16 activations at F=128 and 512 (the widths the step gives
    them; K4ᵀa's at 128 off the path): each against its plain version
    (``compare_bf16``), two launches bit-equal, with its kernel, plain and
    library times, the f32 form's time on the same values widened
    (``f32_ms``) and the widened route's (``widened_ms``: the f32 form on
    ``.float()`` copies, the output rounded to bf16), and its bound from
    the bytes it moves (tiles, slabs and outputs at 2 bytes a value) and
    its operations (K4a, K4ᵀa: f32 FMAs per tile non-zero; K5a: one bf16
    tensor-core pass over every tile, at 256 over the live quadrants).
    Where the plan has occupancy words (edge 256), K4a and K4ᵀa walk their
    live quadrants, bit for bit the walks without them, and K5a runs on the
    live list, bit for bit the full grid on every listed quadrant and +0 on
    the others.  Returns the rows by ID, ``tag`` ("" or "@256") after
    each."""
    from fitgnn_tpu_torch.ops.bsr_dynamic import (
        dyn_grad_blocks, dyn_grad_blocks_plain, dyn_tiles, dyn_tiles_plain,
        dyn_tiles_t, dyn_tiles_t_plain)

    bf16 = torch.bfloat16
    b, plan = hd.bsr, hd.dyn_plan
    check(b.blocks.dtype == bf16, f"K4a{tag}: the mask is not bf16")
    n, edge = hd.num_nodes, b.block
    nb, k_all = n // edge, b.nnz_blocks
    words = plan.words is not None
    nowords = dataclasses.replace(plan, words=None, t_words=None)
    if words:
        quads, q_slabs, qt_slabs = dyn_live_quadrants(b, plan)
    mask = b.blocks > 0
    pe = torch.where(mask, torch.rand(mask.shape, generator=gen,
                                      device=device), 0.0).to(bf16)
    pe32 = pe.float()
    nnz = int(mask.sum())
    nz = mask.nonzero()
    a_rows = b.rows.long()[nz[:, 0]] * edge + nz[:, 1]
    a_cols = b.cols.long()[nz[:, 0]] * edge + nz[:, 2]
    a_vals = pe[nz[:, 0], nz[:, 1], nz[:, 2]]
    del mask, nz
    try:
        a_csr = torch.sparse_coo_tensor(torch.stack([a_rows, a_cols]),
                                        a_vals, (n, n)).coalesce(
                                        ).to_sparse_csr()
        a_t_csr = torch.sparse_coo_tensor(torch.stack([a_cols, a_rows]),
                                          a_vals, (n, n)).coalesce(
                                          ).to_sparse_csr()
    except (RuntimeError, NotImplementedError) as exc:
        a_csr = a_t_csr = None
        print(f"  bf16 CSR refused: {str(exc).splitlines()[0]}")
    del a_rows, a_cols, a_vals
    uniq_cols = int(torch.unique(b.cols).numel())
    uniq_rows = int(torch.unique(b.rows).numel())
    tile_bytes = k_all * edge * edge * 2
    idx_bytes = (2 * k_all + nb + 1) * 4
    kt = plan.t_sel.numel()
    out = {f"{k}{tag}": [] for k in ("K4a", "K4Ta", "K5a")}
    live = plan.live
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            for feat in (NUM_FEATURES, HIDDEN):
                x = torch.randn((n, feat), generator=gen,
                                device=device).to(bf16)
                gr = torch.randn((n, feat), generator=gen,
                                 device=device).to(bf16)
                x32, g32 = x.float(), gr.float()
                print(f"bf16 activations F={feat}"
                      f"{' at edge ' + str(edge) if tag else ''}:")
                runs = {
                    "K4a": (lambda: dyn_tiles(b.rows, b.cols, plan, pe, x),
                            lambda: dyn_tiles_plain(b.rows, b.cols, plan,
                                                    pe, x),
                            lambda: dyn_tiles(b.rows, b.cols, plan, pe32,
                                              x32),
                            lambda: dyn_tiles(b.rows, b.cols, plan,
                                              pe.float(), x.float()).to(bf16),
                            lambda: dyn_tiles(b.rows, b.cols, nowords, pe,
                                              x),
                            None if a_csr is None
                            else lambda: torch.sparse.mm(a_csr, x)),
                    "K4Ta": (lambda: dyn_tiles_t(plan, pe, gr),
                             lambda: dyn_tiles_t_plain(plan, pe, gr),
                             lambda: dyn_tiles_t(plan, pe32, g32),
                             lambda: dyn_tiles_t(plan, pe.float(),
                                                 gr.float()).to(bf16),
                             lambda: dyn_tiles_t(nowords, pe, gr),
                             None if a_t_csr is None
                             else lambda: torch.sparse.mm(a_t_csr, gr)),
                    "K5a": (lambda: dyn_grad_blocks(b.rows, b.cols, gr, x,
                                                    edge, live),
                            lambda: dyn_grad_blocks_plain(b.rows, b.cols, gr,
                                                          x, edge, live),
                            lambda: dyn_grad_blocks(b.rows, b.cols, g32, x32,
                                                    edge, live),
                            lambda: dyn_grad_blocks(
                                b.rows, b.cols, gr.float(), x.float(), edge,
                                live).to(bf16),
                            lambda: dyn_grad_blocks(b.rows, b.cols, gr, x,
                                                    edge),
                            None)}
                # K5a's library yardstick: one bmm of pre-gathered bf16
                # slabs (the gather excluded), every tile
                gs = gr.reshape(nb, edge, feat).index_select(0,
                                                             b.rows.long())
                xs = x.reshape(nb, edge, feat).index_select(0, b.cols.long())
                for k, (call, plain, f32, wide, without, lib) in runs.items():
                    name = f"{k}{tag}"
                    got, again, ref = call(), call(), plain()
                    torch.cuda.synchronize()
                    err = compare_bf16(f"{name} F={feat}", got, ref)
                    check(torch.equal(got, again),
                          f"{name} F={feat}: two launches differ")
                    if words:
                        other = without()
                        if k == "K5a":
                            nq = edge // 128
                            keep = torch.zeros(k_all * nq * nq,
                                               dtype=torch.bool,
                                               device=device)
                            keep[live.long()] = True

                            def quads_of(t):
                                return t.reshape(k_all, nq, 128, nq,
                                                 128).transpose(2, 3).reshape(
                                                     -1, 128, 128)

                            q5, qf = quads_of(got), quads_of(other)
                            dead = q5[~keep]
                            check(torch.equal(q5[keep], qf[keep])
                                  and bool((dead == 0).all())
                                  and not bool(dead.signbit().any()),
                                  f"{name} F={feat}: not the full grid on "
                                  "the live quadrants and +0 elsewhere")
                            del q5, qf, dead, keep
                        else:
                            check(torch.equal(got, other),
                                  f"{name} F={feat}: the walk with words is "
                                  "not the walk without them bit for bit")
                        del other
                    if k == "K5a":
                        # one bf16 pass against 3xTF32 on the same values:
                        # the same products, f32 sums in another order
                        d = (got.float() - wide().float()).abs()
                        print(f"  {name} F={feat}: |K5a - K5 on the widened "
                              f"values, rounded| max {float(d.max()):.3e}, "
                              f"{int((d != 0).sum())} of {d.numel()} "
                              "entries differ")
                        del d
                    del got, again, ref
                    # (bytes, operations, the rate of those operations):
                    # over the live quadrants with the words, and over
                    # every tile (``bound_tiles_ms``) beside it
                    out_bytes = n * feat * 2
                    if k == "K4a":
                        tiles_w = (tile_bytes + idx_bytes
                                   + uniq_cols * edge * feat * 2 + out_bytes,
                                   2.0 * nnz * feat, PEAK_F32_FLOP_PER_S)
                        live_w = ((quads * 128 * 128 * 2
                                   + (k_all + nb + 1) * 4 + k_all * 8
                                   + q_slabs * 128 * feat * 2 + out_bytes,
                                   2.0 * nnz * feat, PEAK_F32_FLOP_PER_S)
                                  if words else tiles_w)
                    elif k == "K4Ta":
                        tiles_w = (tile_bytes + (3 * kt + nb + 1) * 4
                                   + uniq_rows * edge * feat * 2 + out_bytes,
                                   2.0 * nnz * feat, PEAK_F32_FLOP_PER_S)
                        live_w = ((quads * 128 * 128 * 2
                                   + (2 * kt + nb + 1) * 4 + kt * 8
                                   + qt_slabs * 128 * feat * 2 + out_bytes,
                                   2.0 * nnz * feat, PEAK_F32_FLOP_PER_S)
                                  if words else tiles_w)
                    else:
                        # the dense output once (zeros included), the
                        # indices, the distinct g and x slabs; one bf16
                        # pass (with the list: over the live quadrants and
                        # the slabs they reach)
                        tiles_w = (tile_bytes + idx_bytes
                                   + (uniq_rows + uniq_cols) * edge * feat
                                   * 2, 2.0 * k_all * edge * edge * feat,
                                   PEAK_BF16_FLOP_PER_S)
                        live_w = ((tile_bytes + idx_bytes + quads * 4
                                   + (qt_slabs + q_slabs) * 128 * feat * 2,
                                   2.0 * quads * 128 * 128 * feat,
                                   PEAK_BF16_FLOP_PER_S)
                                  if words else tiles_w)
                    by, tiles_b = bound(*live_w), bound(*tiles_w)
                    sh = dict(
                        F=feat, shape=f"F={feat}",
                        on_path=not (k == "K4Ta" and feat != HIDDEN),
                        **err, bound_ms=by[0], bound_by=by[1],
                        bound_tiles_ms=tiles_b[0],
                        ms=cuda_ms(call, 20), f32_ms=cuda_ms(f32, 20),
                        widened_ms=cuda_ms(wide, 20),
                        plain_ms=cuda_ms(plain, 3),
                        library_ms=(cuda_ms(lambda: torch.bmm(
                            gs, xs.transpose(1, 2)), 10) if k == "K5a"
                            else None if lib is None
                            else _library_bf16(lib)),
                        library_label=(
                            "torch.bmm on pre-gathered bf16 slabs (the "
                            "gather excluded), every tile" if k == "K5a"
                            else "torch.sparse.mm on a bf16 CSR of the "
                            "tile non-zeros" + (" (transposed)"
                                                if k == "K4Ta" else "")))
                    if words:
                        sh["live_quadrants"] = quads
                        sh["nowords_ms"] = cuda_ms(without, 10)
                    out[name].append(sh)
                    lib_ms = sh["library_ms"]
                    print(f"  {name} F={feat}: kernel_ms={sh['ms']:.4f} "
                          f"(f32 form {sh['f32_ms']:.4f}, widened route "
                          f"{sh['widened_ms']:.4f}"
                          + (f", without words {sh['nowords_ms']:.4f}"
                             if words else "")
                          + f") plain_ms={sh['plain_ms']:.4f} library_ms="
                          + ("null" if lib_ms is None else f"{lib_ms:.4f}")
                          + f" bound_ms={sh['bound_ms']:.4f} "
                          f"({sh['bound_by']}) bound_tiles_ms="
                          f"{sh['bound_tiles_ms']:.4f}")
                del x, gr, x32, g32, gs, xs, runs
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def gat_bench_operator(g):
    """bench.py's GAT operator on phase 3's node order: ``build_hybrid(...,
    semantics="att_unit", tile_dtype=torch.bfloat16, min_block_edges=32,
    use_segmm=True, block=128)`` on the presence weights, as
    ``build_optimized_graph(layer_name="GATConv")`` builds it; its split
    printed."""
    from fitgnn_tpu_torch.graph.optimize import _operator_weights
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

    t0 = time.perf_counter()
    s, r = g.senders.numpy(), g.receivers.numpy()
    w, n = g.edge_weight.numpy(), g.num_nodes_padded
    h = build_hybrid(s, r, _operator_weights(s, r, w, n, "att_unit"), n,
                     semantics="att_unit", tile_dtype=torch.bfloat16,
                     min_block_edges=GAT_BENCH_THRESHOLD, use_segmm=True,
                     block=128, real_nodes=NUM_NODES)
    b = h.bsr
    check(b is not None and b.blocks.dtype == torch.bfloat16
          and h.dyn_plan is not None and h.segmm is not None,
          "bench GAT operator: no bf16 tiles with a plan and stragglers")
    live = (b.blocks != 0).flatten(1).any(1)
    print(f"bench GAT operator (threshold {GAT_BENCH_THRESHOLD}, bf16 mask): "
          f"{int(live.sum())} live tiles (+{b.nnz_blocks - int(live.sum())} "
          f"fillers), {int((h.weights != 0).sum())} stragglers; "
          f"{time.perf_counter() - t0:.1f} s")
    return h


def phase_bf16_dyn(device, g, ops15) -> tuple:
    """Phase 27: GAT's two-stage tile path on bf16 activations, in bench.py's
    GAT configuration (``gat_bench_operator``, edge 128) and at edge 256 on
    phase 15's threshold-48 operator with bf16 tiles (``t48bf``): K4a,
    K4ᵀa and K5a on each operator's tiles (``dyn_a_kernel_rows``), then
    ``bf16_dyn_steps``.  Returns (the kernel rows, the launch counts by
    phase)."""
    t_phase = time.perf_counter()
    hb = gat_bench_operator(g)
    gen = torch.Generator(device=device).manual_seed(27)
    shapes = dyn_a_kernel_rows(device, hb.to(device), gen)
    shapes.update(dyn_a_kernel_rows(device, ops15["t48bf"].aux.to(device),
                                    gen, f"@{EDGE}"))
    torch.cuda.empty_cache()
    phases = bf16_dyn_steps(device, (
        ("edge 128 t32bf", g._replace(aux=hb), ""),
        (f"edge {EDGE} t48bf", ops15["t48bf"], f"@{EDGE}")))
    print(f"phase 27: {time.perf_counter() - t_phase:.1f} s")
    return shapes, phases


def bf16_dyn_steps(device, runs) -> dict:
    """Through the library surface, on each (name, graph, tag) of ``runs``:
    ``NodeModel("GATConv", 128, 512, 2, 40, dtype=torch.bfloat16,
    dropout_rate=0.5, bit_dropout=True)``, one eval forward and one
    ``steps.gc_train_step`` with every counter at 0 just before, launching
    ``BF16_DYN_STEP`` (K4a, K4ᵀa, K5a under their ``@256`` IDs at 256) and
    no f32 form of K4, K4ᵀ or K5, calling ``kernels.widened`` never, and
    handing K4a, K4ᵀa and K5a bf16 operands at ``BF16_DYN_WIDTHS``; held
    against the same run with the plain versions (the loss within 1e-2
    relative, each gradient f32 and within 5e-2·max|ref|, the eval forward
    within 2e-2·max(1, max|ref|)), its eval forward printed beside the f32
    twin's (the same model without ``dtype`` on the same operator); then
    the step and eval forward timed (CUDA events over
    ``EDGE_TIMED_STEPS``) for both, in one call."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.ops import bsr_dynamic, kernels
    from fitgnn_tpu_torch.train import steps

    bf16 = torch.bfloat16
    phases, times = {}, {}
    for what, gr, tag in runs:
        gd = gr.to(device)

        def make(dtype):
            mdl = NodeModel("GATConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                            dtype=dtype, dropout_rate=0.5, bit_dropout=True)
            return mdl.reset_parameters(
                torch.Generator().manual_seed(0)).to(device)

        name = f"bf16a gat two-stage {what} step and eval"
        widened, widths = [], []
        wide, count = kernels.widened, bsr_dynamic._count

        def counted_widened(*a, **kw):
            widened.append(1)
            return wide(*a, **kw)

        def counted(fn, x):
            widths.append((fn.__name__, x.dtype, x.shape[1]))
            count(fn, x)

        reset_counts()
        with mock.patch.object(kernels, "widened", counted_widened), \
                mock.patch.object(bsr_dynamic, "_count", counted):
            fwd, loss, grads = eval_and_step(make(bf16), gd, device)
        launches = read_counts()
        launches = at_edge(launches) if tag else launches
        expect(launches, {f"{k}{tag}": v for k, v in BF16_DYN_STEP.items()},
               name)
        phases[name] = launches
        check(not widened, f"{name}: kernels.widened called "
              f"{len(widened)} times")
        seen = {k: sorted(f for fn, _, f in widths if fn == k)
                for k in BF16_DYN_WIDTHS}
        check(seen == BF16_DYN_WIDTHS
              and all(d == bf16 for _, d, _ in widths),
              f"{name}: widths {seen} ({set(d for _, d, _ in widths)}), "
              f"expected {BF16_DYN_WIDTHS} in bf16")
        with plain_versions():
            fwd_p, loss_p, grads_p = eval_and_step(make(bf16), gd, device)
        check(abs(float(loss) - float(loss_p)) <= 1e-2 * abs(float(loss_p)),
              f"{name}: loss {float(loss)} against the plain versions' "
              f"{float(loss_p)}")
        for k, v in grads_p.items():
            err = float((grads[k] - v).abs().max())
            check(grads[k].dtype == torch.float32
                  and err <= 5e-2 * float(v.abs().max()),
                  f"{name}: grad {k} off the plain versions' by {err:.3e}")
        scale = max(1.0, float(fwd_p.abs().max()))
        err = float((fwd - fwd_p).abs().max())
        check(err <= 2e-2 * scale, f"{name}: eval forward off the plain "
              f"versions' by {err:.3e}")
        fwd32 = eval_and_step(make(None), gd, device)[0]
        print(f"{name}: loss {float(loss):.5f} (plain {float(loss_p):.5f});"
              f" eval log-probs max |bf16 - f32 twin| "
              f"{float((fwd - fwd32).abs().max()):.4f} of "
              f"{float(fwd32.abs().max()):.4f}")
        for label, dtype in (("bf16", bf16), ("f32", None)):
            model = make(dtype)
            opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
            gen = torch.Generator(device=device).manual_seed(0)
            step = cuda_ms(lambda: steps.gc_train_step(
                model, opt, gd, gd.y, gd.train_mask, gen, "classification"),
                EDGE_TIMED_STEPS)
            model.eval()
            with torch.inference_mode():
                ev = cuda_ms(lambda: model(gd.x, gd), EDGE_TIMED_STEPS)
            times[f"{what} {label}"] = (step, ev)
        del gd, model, fwd, fwd_p, fwd32, grads, grads_p
        torch.cuda.empty_cache()
    print(f"bf16a gat two-stage ms (hidden 512, dropout 0.5, CUDA events "
          f"over {EDGE_TIMED_STEPS}; step / eval forward): "
          + ", ".join(f"{k} {s_:.3f} / {e:.3f}" for k, (s_, e)
                      in times.items()))
    return phases


def summarize(name, route, source, replaces, launches, per_shape) -> dict:
    """One kernel's line: times and bounds summed over the shapes one step
    or forward launches it at (those not marked ``on_path: False``); errors
    are the worst over every shape checked; ``launches`` is the sum over
    the main-path phases, ``launches_by_phase`` beside it."""
    path = [s for s in per_shape if s.get("on_path", True)]
    top = max(path, key=lambda s: s["bound_ms"])
    libs = [s["library_ms"] for s in path]
    extra = {}
    if "two_stage_label" in top:
        # a yardstick may cover several rows (K7bt's two launches): it sits
        # on one of them and is None on the others
        twos = [s["two_stage_ms"] for s in path
                if s["two_stage_ms"] is not None]
        extra = {"two_stage_ms": sum(twos) if twos else None,
                 "two_stage_label": top["two_stage_label"]}
    if "library_label" in top:
        extra["library_label"] = top["library_label"]
    return {
        "name": name, "route": route, "source": source,
        "replaces": replaces, "status": "ok",
        "launches": sum(launches.values()), "launches_by_phase": launches,
        "max_abs_err": max(s["max_abs_err"] for s in per_shape),
        "ms": sum(s["ms"] for s in path),
        "plain_ms": sum(s["plain_ms"] for s in path),
        "bound_ms": sum(s["bound_ms"] for s in path),
        "bound_by": top["bound_by"],
        "library_ms": None if None in libs else sum(libs),
        **extra,
        "per_shape": per_shape,
    }


KERNELS = (
    ("K1", "K1 bsr_spmm_acc", "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:200"),
    ("K3", "K3 segmm_spmm", "fitgnn_tpu_torch/csrc/coo_segmm.cu",
     "fitgnn_tpu/ops/pallas/coo_segmm.py:187"),
    ("K4", "K4 dyn_tiles (bsr_spmm_dyn forward)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K4T", "K4 dyn_tiles_t (bsr_spmm_dyn dx, transposed)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K5", "K5 dyn_grad_blocks (bsr_spmm_dyn dblocks)",
     "fitgnn_tpu_torch/csrc/bsr_dynamic.cu",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:122"),
    ("K3w", "K3w segmm_weighted_raw (segmm_weighted_spmm)",
     "fitgnn_tpu_torch/csrc/coo_segmm.cu",
     "fitgnn_tpu/ops/pallas/coo_segmm.py:370"),
    ("K6", "K6 segmm_weighted_den_raw (segmm_weighted_spmm_den)",
     "fitgnn_tpu_torch/csrc/coo_segmm.cu",
     "fitgnn_tpu/ops/pallas/coo_segmm.py:236"),
    ("K7rm", "K7 att_rowmax", "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:78"),
    ("K7f", "K7 att_fwd (att_tiles forward: the rows walk, pe per "
     "non-zero)", "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/att_bsr.py:125"),
    ("K7bt", "K7 att_bwd_t dx (att_tiles dx: the columns walk of "
     "tile_sparse.cuh, pe per non-zero)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/att_bsr.py:185"),
    ("K7s", "K7 att_bwd_scores (att_tiles' score gradients: each forward "
     "tile's row and column partials of d_raw in one tensor-core pass; "
     "replaces _bwd_f_kernel and the dssrc half of _bwd_t_kernel, :185)",
     "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:267"),
    ("K7sums", "K7 att_sums (dsdst and dssrc from the pass's partials, over "
     "the forward walk and the transpose plan: the tile sums of "
     "_bwd_f_kernel and _bwd_t_kernel)",
     "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:185"),
    ("K2", "K2 bsr_spmm_fwd (bsr_spmm from zero)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:156"),
    ("K8", "K8 diag_spmm (diag_spmm_raw)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/diag_spmm.py:34"),
    ("K9", "K9 bsr_spmm_grouped (grouped tile walk)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:264"),
    ("K10", "K10 bsr_spmm_rowwalk (row walk)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:330"),
    ("K11", "K11 philox_dropout (fused_dropout forward and backward)",
     "fitgnn_tpu_torch/csrc/dropout.cu",
     "fitgnn_tpu/ops/pallas/dropout.py:29"),
    # the bf16 forms (train --hybrid_bf16_tiles), phase 11
    ("K1bf", "K1 bsr_spmm_acc on bf16 tiles (x rounded to bf16)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:200"),
    ("K2bf", "K2 bsr_spmm_fwd on bf16 tiles (x rounded to bf16)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:156"),
    ("K8bf", "K8 diag_spmm on bf16 diagonal blocks (x rounded to bf16)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/diag_spmm.py:34"),
    ("K9bf", "K9 bsr_spmm_grouped on bf16 tiles (x rounded to bf16)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:264"),
    ("K10bf", "K10 bsr_spmm_rowwalk on bf16 tiles (x not rounded)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:330"),
    ("K7rmbf", "K7 att_rowmax on the bf16 mask",
     "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:78"),
    ("K7fbf", "K7 att_fwd on the bf16 mask",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/att_bsr.py:125"),
    ("K7btbf", "K7 att_bwd_t dx on the bf16 mask",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/att_bsr.py:185"),
    ("K7sbf", "K7 att_bwd_scores on the bf16 mask (the score pass)",
     "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:267"),
    # the forms at tile edge 256 (the quadrant walk), phase 14
    ("K1@256", "K1@256 bsr_spmm_acc on 256-wide tiles (128-wide "
     "quadrants)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:200"),
    ("K2@256", "K2@256 bsr_spmm_fwd on 256-wide tiles",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:156"),
    ("K8@256", "K8@256 diag_spmm on 256-wide diagonal blocks",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/diag_spmm.py:34"),
    ("K9@256", "K9@256 bsr_spmm_grouped on 256-wide tiles",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:264"),
    ("K1bf@256", "K1bf@256 bsr_spmm_acc on 256-wide bf16 tiles (x "
     "rounded to bf16)", "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:200"),
    ("K2bf@256", "K2bf@256 bsr_spmm_fwd on 256-wide bf16 tiles",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:156"),
    ("K8bf@256", "K8bf@256 diag_spmm on 256-wide bf16 diagonal blocks",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/diag_spmm.py:34"),
    ("K9bf@256", "K9bf@256 bsr_spmm_grouped on 256-wide bf16 tiles",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:264"),
    # GAT's forms at tile edge 256, phase 15
    ("K4@256", "K4@256 dyn_tiles on 256-wide attention tiles (128-wide "
     "quadrants)", "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K4T@256", "K4T@256 dyn_tiles_t on 256-wide attention tiles (the "
     "transpose plan's quadrants, read transposed)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K5@256", "K5@256 dyn_grad_blocks on 256-wide tiles (one tensor-core "
     "CTA a live 128-wide quadrant of the plan's live list, the empty "
     "quadrants written as +0 in the same launch)",
     "fitgnn_tpu_torch/csrc/bsr_dynamic.cu",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:122"),
    # GAT's fused forms at tile edge 256, phase 16
    ("K7rm@256", "K7rm@256 att_rowmax on 256-wide masks (a CTA a 128-row "
     "half, over its quadrants)", "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:78"),
    ("K7f@256", "K7f@256 att_fwd on 256-wide masks (the rows walk of the "
     "live quadrants of the plan's occupancy words under att::FwdScores)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/att_bsr.py:125"),
    ("K7bt@256", "K7bt@256 att_bwd_t dx on 256-wide masks (the columns "
     "walk of the live quadrants of the plan's transpose words under "
     "att::DxScores)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/att_bsr.py:185"),
    ("K7s@256", "K7s@256 att_bwd_scores' pass on 256-wide masks (one "
     "tensor-core CTA a live 128-wide quadrant, the plan's live list; "
     "partials (K, 2·256))",
     "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:267"),
    ("K7sums@256", "K7sums@256 att_sums on the quadrant partials (one "
     "warp a 128-row block; the live quadrants' partials of the plan's "
     "words alone)",
     "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:185"),
    ("K7rmbf@256", "K7rmbf@256 att_rowmax on 256-wide bf16 masks",
     "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:78"),
    ("K7fbf@256", "K7fbf@256 att_fwd on 256-wide bf16 masks",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/att_bsr.py:125"),
    ("K7btbf@256", "K7btbf@256 att_bwd_t dx on 256-wide bf16 masks",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/att_bsr.py:185"),
    ("K7sbf@256", "K7sbf@256 att_bwd_scores' pass on 256-wide bf16 masks",
     "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:267"),
    # the bf16-activation forms (the conv stack's dtype=bf16), phase 26
    ("K1a", "K1a bsr_spmm_acc on bf16 activations (f32 tiles; the slab "
     "read as bf16, sums f32, rounded once)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:200"),
    ("K1bfa", "K1bfa bsr_spmm_acc on bf16 activations and bf16 tiles",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:200"),
    ("K3a", "K3a segmm_spmm on bf16 activations (each weight rounded to "
     "bf16 first)", "fitgnn_tpu_torch/csrc/coo_segmm.cu",
     "fitgnn_tpu/ops/pallas/coo_segmm.py:187"),
    ("K3wa", "K3wa segmm_weighted_raw on bf16 activations (K3a's kernel, "
     "runtime weights)", "fitgnn_tpu_torch/csrc/coo_segmm.cu",
     "fitgnn_tpu/ops/pallas/coo_segmm.py:370"),
    ("K6a", "K6a segmm_weighted_den_raw on bf16 activations (den f32 over "
     "the unrounded weights)", "fitgnn_tpu_torch/csrc/coo_segmm.cu",
     "fitgnn_tpu/ops/pallas/coo_segmm.py:236"),
    ("K11a", "K11a philox_dropout on bf16 activations (the f32 form's "
     "mask, the bf16 scale)", "fitgnn_tpu_torch/csrc/dropout.cu",
     "fitgnn_tpu/ops/pallas/dropout.py:29"),
    # GAT's dynamic tiles on bf16 activations, phase 27
    ("K4a", "K4a dyn_tiles on bf16 activations (bf16 pe tiles; the slab "
     "read as bf16, sums f32, rounded once)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K4Ta", "K4Ta dyn_tiles_t on bf16 activations (the columns walk on "
     "bf16 pe tiles and a bf16 slab)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K5a", "K5a dyn_grad_blocks on bf16 activations (one bf16 wgmma pass, "
     "bf16x1.cuh; dB rounded to bf16 once)",
     "fitgnn_tpu_torch/csrc/bsr_dynamic.cu",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:122"),
    ("K4a@256", "K4a@256 dyn_tiles on bf16 activations and 256-wide bf16 "
     "tiles (the walk of the plan's live quadrants)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K4Ta@256", "K4Ta@256 dyn_tiles_t on bf16 activations and 256-wide "
     "bf16 tiles (the transpose words' live quadrants)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K5a@256", "K5a@256 dyn_grad_blocks on bf16 activations (one bf16 "
     "wgmma CTA a live 128-wide quadrant, the empty ones +0)",
     "fitgnn_tpu_torch/csrc/bsr_dynamic.cu",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:122"),
)


def register_records(regs, kernels_line) -> None:
    """Puts each kernel's ``ptxas`` register and spill counts (``regs``,
    ``phase_build``'s) into its entry of ``kernels_line``, and checks
    that every form it expects was built."""
    # the register counts of K7's walks (both slab copies), of the score
    # pass and K5 (both load widths), each at 128 and in its quadrant form
    # at 256 (QUAD, the last template flag), and of the column sum and of
    # the straggler sum (K3 and K3w without den, K6 with it: three lane
    # counts, two load widths each)
    for (k, *_), entry in zip(KERNELS, kernels_line["kernels"]):
        base, _, edge = k.partition("@")
        if base in ("K1a", "K1bfa"):
            # the rows walk from init on bf16 activations (its last
            # template parameter), f32 or bf16 tiles: two load widths
            tiles = "float" if base == "K1a" else "__nv_bfloat16"
            entry["registers"] = {
                kernel: {"registers": n, "spilled_bytes": spill}
                for t, kernel, n, spill in regs
                if t == "bsr_spmm" and kernel.replace(" ", "").endswith(
                    f"sparse::Plain,{tiles},false,false,false,"
                    "__nv_bfloat16>")}
            check(len(entry["registers"]) == 2,
                  f"{entry['name']}: no ptxas record of its walk")
            print(f"{k} registers: {entry['registers']}")
            continue
        if base in ("K4a", "K4Ta"):
            # the dynamic tiles' walks on bf16 tiles and activations (A,
            # the last template parameter): at 128 the walk (QUAD and
            # WORDS off), at 256 the walk of the live quadrants
            form = ("sparse::Plain,__nv_bfloat16,false,"
                    + ("true,true" if edge else "false,false")
                    + ",__nv_bfloat16>")
            entry["registers"] = {
                kernel: {"registers": n, "spilled_bytes": spill}
                for t, kernel, n, spill in regs
                if t == "bsr_dynamic" and kernel.replace(" ", "").endswith(
                    form) and walk_args(kernel)[0] == (base == "K4Ta")}
            check(len(entry["registers"]) == 2,
                  f"{entry['name']}: no ptxas record of its walk")
            print(f"{k} registers: {entry['registers']}")
            continue
        if edge and base in ("K1", "K2", "K9", "K1bf", "K2bf", "K9bf", "K4",
                             "K4T"):
            # the walk of the live quadrants (WORDS, then QUAD): K1's from
            # init, K2's and K9's from zero, x rounded on bf16 tiles (the
            # static walks' library); K4's rows and K4ᵀ's columns (the
            # dynamic tiles' library)
            form = ("sparse::Plain,__nv_bfloat16,true,true,true,float>"
                    if base.endswith("bf") else
                    "sparse::Plain,float,false,true,true,float>")
            lib = "bsr_dynamic" if base in ("K4", "K4T") else "bsr_spmm"
            entry["registers"] = {
                kernel: {"registers": n, "spilled_bytes": spill}
                for t, kernel, n, spill in regs
                if t == lib and kernel.replace(" ", "").endswith(form)
                and walk_args(kernel)[:2] == (base == "K4T",
                                              base[:2] == "K1")}
            check(len(entry["registers"]) == 2,
                  f"{entry['name']}: no ptxas record of its words walk")
            print(f"{k} registers: {entry['registers']}")
            continue
        hook = {"K7f": "FwdScores", "K7bt": "DxScores"}.get(base)
        name = {"K5": "dyn_grad_blocks_kernel<", "K5a":
                "dyn_grad_blocks_kernel<", "K7s": "att_scores_kernel",
                "K7sums": "att_sums_kernel",
                "K3": "segmm_spmm_kernel<false", "K3w":
                "segmm_spmm_kernel<false", "K6": "segmm_spmm_kernel<true",
                "K3a": "segmm_spmm_kernel<false", "K3wa":
                "segmm_spmm_kernel<false", "K6a": "segmm_spmm_kernel<true"
                }.get(base)
        if hook is None and name is None:
            continue
        # the straggler sum's last template parameter is its activations'
        # type; the walk's (after QUAD) is f32 for every hook form; K5's
        # (after QUAD) its operands' type, f32 or bf16 (K5a)
        quad = ("float>" if base in ("K3", "K3w", "K6")
                else "__nv_bfloat16>" if base in ("K3a", "K3wa", "K6a")
                else "" if base == "K7sums"
                else ("true" if edge else "false")
                + (", float>" if hook is not None or base == "K5"
                   else ", __nv_bfloat16>" if base == "K5a" else ">"))
        entry["registers"] = {
            kernel: {"registers": n, "spilled_bytes": spill}
            for _, kernel, n, spill in regs
            if kernel.endswith(quad)
            and ((hook is not None
                  and (walk_args(kernel) or (None,) * 4)[3] == hook)
                 or (name is not None and kernel.startswith(name)))}
        # two load widths each, K7f, K7bt and K7s also on bf16 tiles; at
        # 256 K7f and K7bt also walk the live quadrants (WORDS) and K7s and
        # K5 run their live grids (LIVE), each beside its form without them;
        # K7sums one kernel at every edge, its QB forms 1, 2 and any
        want = {"K7sums": 3, "K3": 6, "K3w": 6, "K6": 6, "K3a": 6,
                "K3wa": 6, "K6a": 6, "K5": 2, "K5a": 2}.get(base, 4)
        if edge and base in ("K7f", "K7bt", "K7s", "K5", "K5a"):
            want *= 2
        check(len(entry["registers"]) == want,
              f"{entry['name']}: no ptxas record of its kernels")
        print(f"{k} registers: {entry['registers']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a GPU", file=sys.stderr)
        return 1
    from fitgnn_tpu_torch.data.datasets import NodeDataset, save_npz_cache
    from fitgnn_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    regs = phase_build()
    phase_small_reference(device)

    x, s, r, y, train = make_graph()
    rest = ~train
    val = rest & (np.random.default_rng(1).random(NUM_NODES) < 0.2)
    ds = NodeDataset("bench", x, s, r, y, train_mask=train, val_mask=val,
                     test_mask=rest & ~val)
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "dataset", "bench"))
        save_npz_cache(os.path.join(tmp, "dataset", "bench", "bench.npz"), ds)
        g, order, shapes = phase_kernels(device, ds)
        gcn_split = (g.aux.bsr.rows, g.aux.bsr.cols, g.aux.bsr.nnz_blocks,
                     g.aux.num_coo_edges)
        g_gat, gat_shapes = phase_gat_kernels(device, ds, g)
        shapes.update(gat_shapes)
        for k, v in phase_fused_kernels(device, g_gat).items():
            shapes.setdefault(k, []).extend(v)
        ops = optin_operators(ds, g)
        shapes.update(phase_optin_kernels(device, g, ops))
        phase_gradients(device, g_gat, g)
        phases = phase_optin_train(device, g, ops)
        del ops
        phases.update(phase_forward_only(device, g))
        phases.update(phase_train(tmp))
        phases.update(phase_gat_serve(tmp))
        serve, serve_avg, serve_avg_dev = phase_serve(device, tmp, g)
        phases.update(serve)
        del g_gat
        torch.cuda.empty_cache()
        curriculum, plain_infer, single = phase_curriculum(
            device, tmp, serve_avg, serve_avg_dev)
        phases.update(curriculum)
        torch.cuda.empty_cache()
        warmed = phase_tools_node(tmp, g)
        phases.update(phase_buckets(device, tmp, plain_infer, warmed))
        del warmed
        torch.cuda.empty_cache()
        graphs, hdiag, sage_gin_shapes = phase_sage_gin_kernels(device, ds,
                                                                gcn_split)
        for k, v in sage_gin_shapes.items():
            shapes[k].extend(v)
        phase_sage_gin_gradients(device, graphs, hdiag)
        phases.update(phase_sage_gin_cli(device, tmp, graphs))
        del graphs, hdiag
        ops = bf16_operators(g)
        shapes.update(phase_bf16_kernels(device, ops, shapes))
        phase_bf16_edge_cases(device, ops)
        phases.update(phase_bf16_steps(device, g, ops))
        t26 = time.perf_counter()
        shapes.update(phase_bf16_act_kernels(device, g, ops))
        phases.update(phase_bf16_act_steps(device, g, ops))
        print(f"phase 26: {time.perf_counter() - t26:.1f} s")
        del ops
        torch.cuda.empty_cache()
        phases.update(phase_bf16_cli(tmp))
        graphs = cluster_operators(ds)
        phases.update(phase_cluster_steps(device, graphs))
        del graphs
        torch.cuda.empty_cache()
        phases.update(phase_cluster_cli(tmp))
        torch.cuda.empty_cache()
        phases.update(phase_graph(device, tmp))
        phase_tools_graph(tmp)
        torch.cuda.empty_cache()
        ops = block_operators(g)
        shapes.update(phase_block_kernels(device, ops))
        phases.update(phase_block_steps(device, g, ops))
        del ops
        torch.cuda.empty_cache()
        ops = gat_block_operators(g, ds, order)
        shapes.update(phase_gat_block_kernels(device, ops["t48"].aux))
        phases.update(phase_gat_block_steps(device, g, ops))
        shapes.update(phase_gat_fused_block_kernels(device, ops))
        phases.update(phase_gat_fused_block_steps(device, g, ops))
        phases.update(phase_gat_optins(device, g, ops))
        dyn_shapes, dyn_phases = phase_bf16_dyn(device, g, ops)
        shapes.update(dyn_shapes)
        phases.update(dyn_phases)
        del ops
        torch.cuda.empty_cache()
        phases.update(phase_hier(device, tmp, ds, g, order))
        torch.cuda.empty_cache()
        phases.update(phase_dist_curriculum(device, tmp, single))
        torch.cuda.empty_cache()
        phases.update(phase_flat(device, tmp, ds, g))
        torch.cuda.empty_cache()
        phases.update(phase_tile_types(device, g))
        phase_tooling(device, g)
        del g
        phases.update(phase_planetoid(tmp))
        torch.cuda.empty_cache()
        phase_products_ingest()

    kernels_line = {"kernels": [
        summarize(label, "cuda", source, replaces,
                  {ph: c.get(k, 0) for ph, c in phases.items()
                   if c.get(k, 0)}, shapes[k])
        for k, label, source, replaces in KERNELS]}
    for entry in kernels_line["kernels"]:
        check(entry["launches"] > 0,
              f"{entry['name']} never launched on a main-path phase")
    register_records(regs, kernels_line)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
