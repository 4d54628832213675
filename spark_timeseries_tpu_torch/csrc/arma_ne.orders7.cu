// The kernels of csrc/arma_ne.cuh for 6 of the 36 orders p, q <= 5;
// the orders files share them out so that their nvcc runs, started
// together, take about the same time.

#include "arma_ne.cuh"

namespace arma_ne {

ARMA_NE_ORDER(0, 0)
ARMA_NE_ORDER(0, 2)
ARMA_NE_ORDER(1, 3)
ARMA_NE_ORDER(1, 4)
ARMA_NE_ORDER(2, 4)
ARMA_NE_ORDER(4, 2)

}  // namespace arma_ne
