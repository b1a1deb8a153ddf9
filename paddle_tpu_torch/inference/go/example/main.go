// Example: load a jit.save'd paddle_tpu_torch model and run one
// inference on zeros of the given shape.
//
//	example [-cpu] <model_prefix> [d0,d1,...]
//
// Build and run: see ../README.md.
package main

import (
	"flag"
	"fmt"
	"os"
	"strconv"
	"strings"

	"paddle_tpu_torch/inference/go/paddle"
)

func main() {
	cpu := flag.Bool("cpu", false, "serve on the CPU instead of the card")
	flag.Parse()
	if flag.NArg() < 1 {
		fmt.Fprintln(os.Stderr, "usage: example [-cpu] <model_prefix> [d0,d1,...]")
		os.Exit(2)
	}
	shape := []int64{1, 1, 28, 28}
	if flag.NArg() > 1 {
		shape = nil
		for _, s := range strings.Split(flag.Arg(1), ",") {
			d, err := strconv.ParseInt(s, 10, 64)
			if err != nil {
				panic(err)
			}
			shape = append(shape, d)
		}
	}
	cfg := paddle.NewAnalysisConfig()
	cfg.SetModel(flag.Arg(0), "")
	if *cpu {
		cfg.DisableGpu()
	}

	pred, err := paddle.NewPredictor(cfg)
	if err != nil {
		panic(err)
	}
	defer pred.Delete()

	n := int64(1)
	for _, d := range shape {
		n *= d
	}
	in, err := paddle.NewTensor(make([]float32, n), shape)
	if err != nil {
		panic(err)
	}
	outs, err := pred.Run([]*paddle.Tensor{in})
	if err != nil {
		panic(err)
	}
	for i, o := range outs {
		fmt.Printf("output %d shape=%v first=%v\n", i, o.Shape, o.Data[0])
	}
}
