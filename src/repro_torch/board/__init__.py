"""Event-driven board-runtime emulator — the paper's PL datapath in software.

The port of ``repro.board``: the third runtime behind the single deployment
artifact. An AER input event queue feeds 16 hardware groups x 128 neurons
(int8 synapse rows, int32 membranes, power-of-two leak shifts), with per-tick
event dispatch, grouped TTFS first-spike decode, and a cycle/energy account
against ``hw.PYNQ_COST`` at 80 MHz, so the Table-3 analogue (cycles/image,
modelled µs/image, nJ/image) falls out of every run. The modelled µs are
cycles at the board's clock, not time taken on the card.

  * ``SNNBoard``        — per-image host scheduler (the audit path)
  * ``SNNBoardBatched`` — batched path on the program's device, its full-T
                          LIF on the ``lif_fused`` CUDA kernel with
                          ``kernel="cuda"`` (bit-exact with the scheduler)
"""

from repro_torch.board.batched import SNNBoardBatched
from repro_torch.board.energy import BoardTrace, account
from repro_torch.board.event_queue import AEREventQueue
from repro_torch.board.neuron_core import GroupedNeuronCore
from repro_torch.board.runtime import SNNBoard

__all__ = ["SNNBoard", "SNNBoardBatched", "BoardTrace", "account",
           "AEREventQueue", "GroupedNeuronCore"]
