package paddle

// Reference: go/paddle/tensor.go (ZeroCopyTensor). The C ABI carries
// float32 data + int64 shapes; Tensor is the Go-side value.  An int64
// input (token ids) goes in as float32, exact below 2^24; the predictor
// casts it to the saved program's dtype.

import "fmt"

// Tensor is a dense float32 array with an int64 shape.
type Tensor struct {
	Data  []float32
	Shape []int64
}

// ZeroCopyTensor is the reference-compatible alias (the ABI copies at
// the boundary; the name is kept for drop-in source compatibility).
type ZeroCopyTensor = Tensor

// NewTensor builds a tensor, validating that len(data) matches shape.
func NewTensor(data []float32, shape []int64) (*Tensor, error) {
	n := int64(1)
	for _, d := range shape {
		n *= d
	}
	if int64(len(data)) != n {
		return nil, fmt.Errorf(
			"paddle: data has %d elements, shape %v needs %d",
			len(data), shape, n)
	}
	return &Tensor{Data: data, Shape: shape}, nil
}

// SetValue replaces the tensor's contents (reference: SetValue).
func (t *Tensor) SetValue(data []float32, shape []int64) error {
	nt, err := NewTensor(data, shape)
	if err != nil {
		return err
	}
	*t = *nt
	return nil
}

// Value returns the data slice (reference: Value interface{}).
func (t *Tensor) Value() []float32 { return t.Data }

// Numel returns the element count.
func (t *Tensor) Numel() int64 {
	n := int64(1)
	for _, d := range t.Shape {
		n *= d
	}
	return n
}
